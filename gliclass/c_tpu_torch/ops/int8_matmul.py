"""INT8-weight matmul: y = (x @ w_q) * scale (+ b), kernel K3.

The weight stays int8 in device memory and is upcast on chip; the
per-output-channel scale commutes with the K reduction and is applied once in
the epilogue, where the bias is fused. On a CUDA tensor :func:`int8_matmul`
launches one of two hand-written kernels (:func:`kernel_variant`): bf16 x on
tensor cores (``csrc/int8_matmul_tc.cu``), every other case on CUDA cores
(``csrc/int8_matmul.cu``). On a CPU tensor it runs
:func:`int8_matmul_plain`, the same arithmetic in PyTorch.

The JAX package's default (``_int8_matmul_xla``) dequantizes on the weight
side and rounds the dequantized weight to the activation dtype before the
product; this port scales the fp32 accumulator instead, which matches the JAX
Pallas kernel. In fp32 the two agree to rounding; in bf16 they differ by the
weight's bf16 rounding.
"""

from __future__ import annotations

import torch

from . import _build
from .fused_attention import CUDA_CORE, TENSOR_CORE

# Kernel launches since the last reset (the main path's proof): every launch
# of K3, and the tensor-core ones among them.
launches = 0
launches_tc = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def kernel_variant(dtype: torch.dtype, K: int, N: int) -> str:
    """The variant of K3 that takes x of this dtype against a [K, N] weight:
    the bf16 tensor-core kernel when x is bfloat16, K is a multiple of 8 and
    N a multiple of 16 (its 16-byte copies of x rows and weight rows), else
    the CUDA-core kernel, which keeps fp32's 1e-4 agreement (TF32 tensor
    cores would round x) and every other shape."""
    tc = dtype == torch.bfloat16 and K % 8 == 0 and N % 16 == 0
    return TENSOR_CORE if tc else CUDA_CORE


def int8_matmul_plain(
    x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor | None = None
) -> torch.Tensor:
    """(x.float() @ w_q.float()) * scale (+ b) in fp32, cast to x's dtype."""
    *lead, k = x.shape
    y = (x.reshape(-1, k).float() @ w_q.float()) * scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype).reshape(*lead, w_q.shape[1])


def int8_matmul(
    x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor | None = None
) -> torch.Tensor:
    """y = (x @ w_q) * scale (+ bias). x [..., K] fp32 or bf16; w_q int8
    [K, N]; scale f32 [N]; bias f32 [N] or None. Output in x's dtype."""
    _build.refuse_grad("int8_matmul", x, scale, bias)
    if not x.is_cuda:
        return int8_matmul_plain(x, w_q, scale, bias)
    global launches, launches_tc
    *lead, K = x.shape
    N = w_q.shape[1]
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"int8_matmul: x must be float32 or bfloat16, got {x.dtype}")
    if w_q.dtype != torch.int8 or w_q.shape[0] != K or not w_q.is_contiguous():
        raise ValueError(f"int8_matmul: w_q must be contiguous int8 [{K}, N], got {w_q.dtype} {tuple(w_q.shape)}")
    if scale.dtype != torch.float32 or scale.shape != (N,):
        raise ValueError("int8_matmul: scale must be f32 [N]")
    if bias is not None and (bias.dtype != torch.float32 or bias.shape != (N,)):
        raise ValueError("int8_matmul: bias must be f32 [N]")
    for t in (w_q, scale) + (() if bias is None else (bias,)):
        if t.device != x.device:
            raise ValueError("int8_matmul: all tensors must be on one device")
    x2 = x.reshape(-1, K).contiguous()
    M = x2.shape[0]
    out = torch.empty((M, N), dtype=x.dtype, device=x.device)
    tc = kernel_variant(x.dtype, K, N) == TENSOR_CORE
    if tc and (x2.data_ptr() % 16 or w_q.data_ptr() % 16):
        # The tensor-core kernel copies 16-byte rows: realign a view that starts off a 16-byte boundary.
        x2, w_q = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (x2, w_q))
    args = (x2.data_ptr(), w_q.data_ptr(), scale.contiguous().data_ptr(),
            None if bias is None else bias.contiguous().data_ptr(), out.data_ptr(), M, N, K, _build.stream_ptr(x))
    if tc:
        rc = _build.lib().gct_int8_matmul_tc(*args)
    else:
        rc = _build.lib().gct_int8_matmul(_DTYPE_CODES[x.dtype], *args)
    _build.check(rc, "int8_matmul")
    launches += 1
    launches_tc += tc
    return out.reshape(*lead, N)
