"""Feed-forward block y = act(x @ up) @ down, with the fused kernels K2 and K4.

Routing (no environment switch), for INT8 weights in reduced precision:

  * ``act_quant`` on (``int8-dynamic``): the fused w8a8 kernel K2
    (``csrc/fused_ffn_w8a8.cu``) — the activated [M, I] intermediate stays on
    chip, re-quantized to int8;
  * ``act_quant`` off (weight-only ``int8``): the weight-only kernel K4, the
    intermediate rounded to x's dtype as in the JAX package's
    ``_kernel_wonly``. With H and I multiples of 16 (:func:`kernel_variant`)
    its two products run on tensor cores (``csrc/fused_ffn_wonly_tc.cu``, two
    launches through an [M, I] bf16 scratch); other shapes take the fused
    CUDA-core kernel (``csrc/fused_ffn_wonly.cu``), which keeps the
    intermediate on chip;

fp weights or fp32 run plain ``linear`` layers (weight-only INT8 ones through
K3). On a CPU tensor each kernel wrapper runs its plain version, the same
arithmetic in PyTorch.
"""

from __future__ import annotations

from typing import Any

import torch

from . import _build
from .fused_attention import CUDA_CORE, TENSOR_CORE
from .layers import act_quant_enabled, activation, gelu_tanh, int_mm, linear, row_quant

Params = dict[str, Any]

launches = 0  # K2 launches since the last reset (the main path's proof)
launches_wonly = 0  # K4 calls since the last reset, one per FFN on either variant
launches_wonly_tc = 0  # the K4 calls among them that took the tensor-core variant


def kernel_variant(H: int, I: int) -> str:
    """The variant of K4 (bf16 x) that takes an FFN of width H and
    intermediate width I: the tensor-core kernel when both are multiples of
    16 (K3′'s core: 16-byte copies of x, h and weight rows, 16-wide output
    tiles), else the fused CUDA-core kernel."""
    return TENSOR_CORE if H % 16 == 0 and I % 16 == 0 else CUDA_CORE


_GELUS = ("gelu", "gelu_new", "gelu_pytorch_tanh")


def _activate(h: torch.Tensor, hidden_act: str) -> torch.Tensor:
    """Activation on the fp32 intermediate; every gelu is the tanh form."""
    return gelu_tanh(h) if hidden_act in _GELUS else activation(hidden_act)(h)


def fused_ffn_w8a8_plain(x, wq_up, s_up, b_up, wq_dn, s_dn, b_dn, hidden_act="gelu"):
    """The kernel's arithmetic in PyTorch: x [M, H] -> [M, H] in x's dtype."""
    x_q, s_x = row_quant(x.float())
    h = int_mm(x_q, wq_up).float() * s_x * s_up + b_up
    h = _activate(h, hidden_act)
    h_q, s_h = row_quant(h)
    y = int_mm(h_q, wq_dn).float() * s_h * s_dn + b_dn
    return y.to(x.dtype)


def fused_ffn_wonly_plain(x, wq_up, s_up, b_up, wq_dn, s_dn, b_dn, hidden_act="gelu"):
    """K4's arithmetic in PyTorch: x [M, H] -> [M, H] in x's dtype. fp32
    sums of x times the upcast weight; the activated intermediate is rounded
    to x's dtype before the down product."""
    h = (x.float() @ wq_up.float()) * s_up + b_up
    h = _activate(h, hidden_act).to(x.dtype)
    y = (h.float() @ wq_dn.float()) * s_dn + b_dn
    return y.to(x.dtype)


def _check_ffn_args(name, x, wq_up, s_up, b_up, wq_dn, s_dn, b_dn, hidden_act):
    if hidden_act not in _GELUS:
        raise ValueError(f"{name} kernel implements tanh-gelu only, got {hidden_act!r}")
    M, H = x.shape
    I = wq_up.shape[1]
    if x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous bf16 [M, H], got {x.dtype}")
    for arg, t, shape, dt in (
        ("wq_up", wq_up, (H, I), torch.int8), ("s_up", s_up, (I,), torch.float32),
        ("b_up", b_up, (I,), torch.float32), ("wq_dn", wq_dn, (I, H), torch.int8),
        ("s_dn", s_dn, (H,), torch.float32), ("b_dn", b_dn, (H,), torch.float32),
    ):
        if t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"{name}: {arg} must be contiguous {dt} {shape} on {x.device}")
    if H % 4 or I % 4:
        raise ValueError(f"{name}: H and I must be multiples of 4")
    return M, H, I


def _launch_ffn(entry: str, x, wq_up, s_up, b_up, wq_dn, s_dn, b_dn, M, H, I):
    lib = _build.lib()
    smem = getattr(lib, entry + "_smem")(H, I)
    limit = torch.cuda.get_device_properties(x.device).shared_memory_per_block_optin
    if smem + 256 > limit:
        raise ValueError(f"{entry}: needs {smem} B of shared memory, the device allows {limit}")
    out = torch.empty_like(x)
    rc = getattr(lib, entry)(
        x.data_ptr(), wq_up.data_ptr(), s_up.data_ptr(), b_up.data_ptr(), wq_dn.data_ptr(),
        s_dn.data_ptr(), b_dn.data_ptr(), out.data_ptr(), M, H, I, _build.stream_ptr(x),
    )
    _build.check(rc, entry)
    return out


def fused_ffn_w8a8(x, wq_up, s_up, b_up, wq_dn, s_dn, b_dn, hidden_act="gelu"):
    """Fused w8a8 FFN. x: [M, H] bf16; wq_up int8 [H, I]; s_up, b_up f32 [I];
    wq_dn int8 [I, H]; s_dn, b_dn f32 [H]."""
    if not x.is_cuda:
        return fused_ffn_w8a8_plain(x, wq_up, s_up, b_up, wq_dn, s_dn, b_dn, hidden_act)
    global launches
    args = (x, wq_up, s_up, b_up, wq_dn, s_dn, b_dn)
    M, H, I = _check_ffn_args("fused_ffn_w8a8", *args, hidden_act)
    out = _launch_ffn("gct_fused_ffn_w8a8", *args, M, H, I)
    launches += 1
    return out


def fused_ffn_wonly(x, wq_up, s_up, b_up, wq_dn, s_dn, b_dn, hidden_act="gelu"):
    """Weight-only INT8 FFN (K4), same arguments as :func:`fused_ffn_w8a8`;
    the variant by :func:`kernel_variant`."""
    if not x.is_cuda:
        return fused_ffn_wonly_plain(x, wq_up, s_up, b_up, wq_dn, s_dn, b_dn, hidden_act)
    global launches_wonly, launches_wonly_tc
    args = (x, wq_up, s_up, b_up, wq_dn, s_dn, b_dn)
    M, H, I = _check_ffn_args("fused_ffn_wonly", *args, hidden_act)
    tc = kernel_variant(H, I) == TENSOR_CORE
    if tc:
        # 16-byte copies of x and weight rows: realign a view that starts off a 16-byte boundary.
        x, wq_up, wq_dn = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (x, wq_up, wq_dn))
        h = torch.empty((M, I), dtype=x.dtype, device=x.device)
        out = torch.empty_like(x)
        rc = _build.lib().gct_fused_ffn_wonly_tc(
            x.data_ptr(), wq_up.data_ptr(), s_up.data_ptr(), b_up.data_ptr(), wq_dn.data_ptr(), s_dn.data_ptr(),
            b_dn.data_ptr(), h.data_ptr(), out.data_ptr(), M, H, I, _build.stream_ptr(x),
        )
        _build.check(rc, "gct_fused_ffn_wonly_tc")
    else:
        out = _launch_ffn("gct_fused_ffn_wonly", *args, M, H, I)
    launches_wonly += 1
    launches_wonly_tc += tc
    return out


def _bias_f32(p: Params, n: int, like: torch.Tensor) -> torch.Tensor:
    b = p.get("b")
    return torch.zeros(n, dtype=torch.float32, device=like.device) if b is None else b.float()


def fused_ffn(p_up: Params, p_down: Params, x: torch.Tensor, hidden_act: str,
              compute_dtype: torch.dtype) -> torch.Tensor:
    """y = act(x @ up) @ down for x [..., H] (routing in the module doc)."""
    quantized = "w_q" in p_up and "w_q" in p_down
    if quantized and compute_dtype != torch.float32:
        kernel = fused_ffn_w8a8 if act_quant_enabled() else fused_ffn_wonly
        *lead, H = x.shape
        I = p_up["w_q"].shape[1]
        y = kernel(
            x.reshape(-1, H).to(compute_dtype).contiguous(),
            p_up["w_q"], p_up["scale"].float(), _bias_f32(p_up, I, x),
            p_down["w_q"], p_down["scale"].float(), _bias_f32(p_down, H, x),
            hidden_act,
        )
        return y.reshape(*lead, H)
    # "gelu" is erf in fp32 and the tanh form in reduced precision (layers._gelu).
    h = activation(hidden_act)(linear(p_up, x, compute_dtype))
    return linear(p_down, h, compute_dtype)
