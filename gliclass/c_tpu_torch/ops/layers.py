"""Core compute primitives: dense (fp / INT8), layer norms, activations.

A "dense param" is a dict of tensors, the JAX package's layout:

    fp   : {"w": [in, out], "b": [out] (optional)}
    int8 : {"w_q": int8 [in, out], "scale": f32 [out], "b": [out] (optional)}

INT8 is per-output-channel symmetric weight quantization, so the scale factors
out of the K reduction and is applied once per output column. With the
:func:`act_quant` context active (``quant_mode="int8-dynamic"``), INT8 dense
layers also quantize their activations per row (w8a8); fp32 keeps weight-only
INT8 regardless.

Under tensor parallelism a row-parallel dense layer (input dim sharded over
the model group) runs through :func:`row_linear`: the local partial product,
the sum over the group, then the bias once.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Any

import torch
import torch.nn.functional as F

from ..parallel.collectives import all_reduce_max, all_reduce_sum, group_size, reduce_from_model

Params = dict[str, Any]

# Set by the engine around its forward: w8a8 for INT8 dense layers.
_ACT_QUANT = contextvars.ContextVar("gliclass_torch_act_quant", default=False)


@contextlib.contextmanager
def act_quant(enabled: bool):
    """Enable w8a8 (dynamic per-row INT8 activations) for INT8 dense layers
    run within this context. Reduced precision only: fp32 keeps weight-only
    INT8."""
    tok = _ACT_QUANT.set(bool(enabled))
    try:
        yield
    finally:
        _ACT_QUANT.reset(tok)


def act_quant_enabled() -> bool:
    return bool(_ACT_QUANT.get())


def wide(x: torch.Tensor) -> torch.Tensor:
    """``x`` for the fp32 sums and statistics of the plain versions: fp32,
    or fp64 where it is fp64 (a decoder bundle's goldens, computed in fp64
    on the CPU, ``convert.forward_golden_logits``)."""
    return x if x.dtype == torch.float64 else x.float()


def full_precision(dtype: torch.dtype) -> bool:
    """fp32 or fp64: one rounding per op, no reduced-precision rules."""
    return dtype in (torch.float32, torch.float64)


def linear(p: Params, x: torch.Tensor, compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """y = x @ w (+ b). fp32: fp32 products and fp32 bias. bf16/f16: output
    and bias add in the compute dtype."""
    if "w_q" in p:
        return _linear_int8(p, x, compute_dtype)
    w = p["w"]
    if compute_dtype is not None:
        x = x.to(compute_dtype)
        w = w.to(compute_dtype)
    b = p.get("b")
    if x.dtype == torch.float32:
        y = x @ w
        if b is not None:
            y = y + b.float()
        return y
    y = x @ w
    if b is not None:
        y = y + b.to(x.dtype)
    return y


def _linear_int8(p: Params, x: torch.Tensor, compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """INT8 dense layer: w8a8 inside :func:`act_quant` (not in fp32), else
    the weight-only INT8 matmul kernel with the bias fused."""
    from .int8_matmul import int8_matmul

    dtype = compute_dtype or x.dtype
    b = p.get("b")
    if act_quant_enabled() and dtype != torch.float32:
        y = _linear_w8a8(p, x)
        if b is not None:
            y = y + b.to(dtype)
        return y.to(dtype)
    return int8_matmul(x.to(dtype), p["w_q"], p["scale"], None if b is None else b.float())


def row_quant(x: torch.Tensor, reciprocal: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric absmax INT8: s = max|x|/127 clamped at 1e-10,
    q = round_half_even(x / s). ``x`` fp32. ``reciprocal``: s = max|x| *
    fp32(1/127), as the JAX package's compiled w8a8 linear computes it
    (its compiler turns the division by the constant into that product;
    the two differ in the last bit of s for some rows, and such a row's
    int8 values can then differ by one step)."""
    return row_quant_amax(x, x.abs().amax(dim=-1, keepdim=True), reciprocal)


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 [M, K] x int8 [K, N] -> int32 [M, N], exact, at any shape; on
    the card through :func:`int_mm_padded`."""
    return int_mm_padded(a, b) if a.is_cuda else torch._int_mm(a, b)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def int_mm_padded(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``torch._int_mm`` on operands padded with zeros to shapes the card
    takes, the result sliced back: exact, since zero rows of ``a`` give rows
    that are cut, zero K columns of ``a`` meet zero K rows of ``b`` and add
    nothing, and zero columns of ``b`` give columns that are cut.

    On the card ``torch._int_mm`` itself checks M > 16 and K, N multiples of
    8, and cuBLASLt refuses more (``CUBLAS_STATUS_NOT_SUPPORTED``;
    ``scripts/int_mm_shapes.py``): at K = 32, 40, 64 and 96 every row
    count M that is not a multiple of 32 (17, 24, 100, 342, 344, 1000, 8190
    among them; 32, 64, 352 and 8192 run), where at K = 8, 16, 256 and 768
    every M > 16 runs. So all three dimensions are padded to multiples of
    32: the main paths' products (M = rows x a seq bucket, rows a power of
    two from 4 on; K and N the model's widths) need no copy."""
    m, k = a.shape
    n = b.shape[1]
    mp, kp, np_ = (_round_up(x, 32) for x in (m, k, n))
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (kp, np_) != (k, n):
        b = F.pad(b, (0, np_ - n, 0, kp - k))
    out = torch._int_mm(a, b)
    return out if (mp, np_) == (m, n) else out[:m, :n]


def row_quant_amax(x: torch.Tensor, amax: torch.Tensor, reciprocal: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`row_quant` of ``x`` with its rows' absmax given ([M, 1]; the
    whole row's, when ``x`` holds a shard of each row)."""
    s = torch.clamp(amax * (1.0 / 127.0) if reciprocal else amax / 127.0, min=1e-10)
    return torch.round(x / s).to(torch.int8), s


def _linear_w8a8(p: Params, x: torch.Tensor, group=None) -> torch.Tensor:
    """Dynamic-quantized INT8 matmul: y = (q(x) @ w_q) * s_x * scale (f32).

    Per-row symmetric activation quantization, int32 accumulation, both
    scales applied once after it. ONNX's DynamicQuantizeLinear is asymmetric
    uint8; this path is symmetric int8 (the JAX package's documented
    divergence, kept here).

    ``group``: x holds this rank's shard of each row (a row-parallel layer).
    The row absmax is then the maximum over the group, so the int8 operand
    is the one process's bit for bit, and the exact int32 partial sums are
    summed over the group before the scales: y equals one process's.

    The activation scale is the JAX package's (``row_quant(...,
    reciprocal=True)``); K2's quantiser keeps its own."""
    *lead, K = x.shape
    xf = x.reshape(-1, K).float()
    if group_size(group) > 1:
        x_q, s_x = row_quant_amax(xf, all_reduce_max(xf.abs().amax(dim=-1, keepdim=True), group), True)
        acc = all_reduce_sum(int_mm(x_q, p["w_q"]), group)
    else:
        x_q, s_x = row_quant(xf, True)
        acc = int_mm(x_q, p["w_q"])
    y = acc.float() * s_x * p["scale"].float()
    return y.reshape(*lead, y.shape[-1])


def row_linear(p: Params, x: torch.Tensor, compute_dtype: torch.dtype | None = None, group=None) -> torch.Tensor:
    """A row-parallel dense layer: ``x`` [..., K/tp] and the weight's
    [K/tp, N] rows are this rank's shards over the model ``group``; the
    result is the whole [..., N] on every rank, in :func:`linear`'s dtype.
    Without a group it is :func:`linear`.

    w8a8 (:func:`act_quant`, reduced precision): the group's row absmax and
    int32 sums (:func:`_linear_w8a8`), then the bias as :func:`linear`
    adds it: one process's bits. Otherwise the partial product without the
    bias, its sum over the group in fp32 (``reduce_from_model``, whose
    backward is the identity), the bias added once in fp32, one rounding to
    the output dtype."""
    if group_size(group) == 1:
        return linear(p, x, compute_dtype)
    b = p.get("b")
    dtype = compute_dtype or x.dtype
    if "w_q" in p and act_quant_enabled() and dtype != torch.float32:
        y = _linear_w8a8(p, x, group)
        if b is not None:
            y = y + b.to(dtype)
        return y.to(dtype)
    part = linear({k: v for k, v in p.items() if k != "b"}, x, compute_dtype)
    y = reduce_from_model(part, group)
    if b is not None:
        y = y + b.float()
    return y.to(part.dtype)


def layer_norm(p: Params, x: torch.Tensor, eps: float, residual: torch.Tensor | None = None) -> torch.Tensor:
    """LayerNorm with {"scale", "bias"}; statistics in fp32. With
    ``residual``, the norm of ``x + residual``, the sum taken in fp32 (the
    JAX package's graph fuses the add into the norm and never rounds it)."""
    xf = x.float() if residual is None else x.float() + residual.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * p["scale"].float() + p["bias"].float()
    return y.to(x.dtype)


def rms_norm(p: Params, x: torch.Tensor, eps: float, residual: torch.Tensor | None = None) -> torch.Tensor:
    """RMSNorm (decoder backbones), fp32 statistics. With ``residual``, the
    norm of ``x + residual``, the sum taken in fp32 (the JAX package's graph
    feeds the unrounded sum to the norm; the residual stream keeps the
    rounded one)."""
    xf = wide(x) if residual is None else wide(x) + wide(residual)
    y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (y * p["scale"].float()).to(x.dtype)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """tanh-approximated gelu, the JAX formula and operation order:
    x * 0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 x^3)))."""
    c = math.sqrt(2.0 / math.pi)
    cdf = 0.5 * (1.0 + torch.tanh(c * (x + 0.044715 * (x * x * x))))
    return x * cdf


def _gelu_tanh_once(x: torch.Tensor) -> torch.Tensor:
    """:func:`gelu_tanh` computed in fp32 and rounded once to x's dtype, as
    the JAX package's fused graph computes it; op by op in bf16 it rounds
    seven times."""
    return gelu_tanh(x.float()).to(x.dtype)


def _gelu_tanh_per_op(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=True)`` on a reduced-precision ``x`` as
    the JAX package's graph runs it: each op rounded to x's dtype, the
    constants too, and the last product x * cdf left in fp32."""
    c = torch.tensor(math.sqrt(2.0 / math.pi), dtype=x.dtype, device=x.device)
    k = torch.tensor(0.044715, dtype=x.dtype, device=x.device)
    cdf = 0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x))))
    return x.float() * cdf.float()


def _silu_per_op(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` on a reduced-precision ``x`` as the JAX package's
    graph runs it, x * (1 / (1 + exp(-x))), each op rounded to x's dtype
    but the last product, left in fp32."""
    return x.float() * (1.0 / (1.0 + torch.exp(-x))).float()


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """erf gelu in fp32 (parity with HF); the tanh form in reduced precision,
    whose difference from erf (< 1.5e-3) is below bf16's rounding."""
    if full_precision(x.dtype):
        return F.gelu(x)
    return _gelu_tanh_once(x)


_ACTIVATIONS = {
    "gelu": _gelu,
    "gelu_new": _gelu_tanh_once,
    "gelu_pytorch_tanh": _gelu_tanh_once,
    "relu": F.relu,
    "silu": F.silu,
    "swish": F.silu,
    "tanh": torch.tanh,
}


def activation(name: str):
    try:
        return _ACTIVATIONS[name]
    except KeyError:
        raise ValueError(f"unsupported activation: {name!r}") from None


_PER_OP = {"gelu": _gelu_tanh_per_op, "gelu_new": _gelu_tanh_per_op, "gelu_pytorch_tanh": _gelu_tanh_per_op,
           "silu": _silu_per_op, "swish": _silu_per_op}


def activation_per_op(name: str):
    """:func:`activation` as the JAX package applies it to an array of the
    compute dtype (the head's projectors, the decoders' gate): in reduced
    precision the tanh gelu and silu round after each op, and their last
    product comes back in fp32 for the layer that takes it (a w8a8 linear
    quantizes it unrounded, any other rounds it first). fp32 input, and the
    other activations, as :func:`activation`; fp64 as fp32."""
    f = activation(name)
    if name not in _PER_OP:
        return f
    per_op = _PER_OP[name]
    return lambda x: f(x) if full_precision(x.dtype) else per_op(x)


def masked_softmax(scores: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Softmax in the scores dtype: exact fp32 for fp32; for reduced
    precision, exp in the input dtype with an fp32 max and sum."""
    if scores.dtype == torch.float32:
        return torch.softmax(scores, dim=dim)
    m = scores.float().amax(dim=dim, keepdim=True)
    e = torch.exp(scores - m.to(scores.dtype))
    denom = e.float().sum(dim=dim, keepdim=True)
    return (e.float() / denom).to(scores.dtype)
