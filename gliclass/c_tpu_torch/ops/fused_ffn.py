"""Feed-forward block y = act(x @ up) @ down, with the fused kernels K2 and K4.

Routing (no environment switch), for INT8 weights in reduced precision:

  * ``act_quant`` on (``int8-dynamic``): the w8a8 kernel K2, the activated
    intermediate re-quantized to int8 per row. With H and I multiples of 16
    (:func:`kernel_variant`) its two products run on int8 tensor cores
    (``csrc/fused_ffn_w8a8_tc.cu``, four launches through [M, I] fp32 and
    int8 scratch) on [N, K] copies of the weights (:func:`nk_weight`, made
    once by the engine: :func:`add_nk_weights`); other shapes take the fused
    CUDA-core kernel (``csrc/fused_ffn_w8a8.cu``), which keeps the
    intermediate on chip. Both give the same bits;
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

Under tensor parallelism (a model ``group``: each rank holds I/tp columns of
the up weight and rows of the down weight) both wrappers give the whole
output on every rank. K2 runs split at the intermediate's row scale: the up
half (launches 1-2, each row's max |h| of this rank's columns), its maximum
over the group, the down half (launches 3-4) with that scale, so that h_q is
the one process's bit for bit, into fp32 partial sums; then their sum over
the group and the bias. Only the tensor-core K2 can split (the CUDA-core one
keeps h on chip), so at other widths the wrapper raises. K4 gives its
partial sums in x's dtype without the bias; their fp32 sum and the bias
follow.
"""

from __future__ import annotations

from typing import Any

import torch

from ..parallel.collectives import all_reduce_max, copy_to_model, group_size, reduce_from_model
from .layers import (act_quant_enabled, activation, gelu_tanh, int_mm, linear, row_linear, row_quant,
                     row_quant_amax)
from . import _build
from .fused_attention import CUDA_CORE, TENSOR_CORE

Params = dict[str, Any]

launches = 0  # K2 calls since the last reset (the main path's proof), one per FFN on either variant
launches_tc = 0  # the K2 calls among them that took the tensor-core variant
launches_split = 0  # the K2 calls among them that ran split at s_h over a model group
launches_wonly = 0  # K4 calls since the last reset, one per FFN on either variant
launches_wonly_tc = 0  # the K4 calls among them that took the tensor-core variant


def kernel_variant(H: int, I: int) -> str:
    """The variant of K2 and K4 (bf16 x) that takes an FFN of width H and
    intermediate width I: the tensor-core kernels when both are multiples of
    16 (16-byte copies of x, h and weight rows, 16-wide output tiles), else
    the fused CUDA-core kernels."""
    return TENSOR_CORE if H % 16 == 0 and I % 16 == 0 else CUDA_CORE


_GELUS = ("gelu", "gelu_new", "gelu_pytorch_tanh")


def _activate(h: torch.Tensor, hidden_act: str) -> torch.Tensor:
    """Activation on the fp32 intermediate; every gelu is the tanh form."""
    return gelu_tanh(h) if hidden_act in _GELUS else activation(hidden_act)(h)


def ffn_w8a8_up_plain(x, wq_up, s_up, b_up, hidden_act="gelu"):
    """K2's up half in PyTorch (launches 1-2): x [M, H] -> (the activated
    intermediate h fp32 [M, I], its rows' absmax [M, 1])."""
    x_q, s_x = row_quant(x.float())
    h = _activate(int_mm(x_q, wq_up).float() * s_x * s_up + b_up, hidden_act)
    return h, h.abs().amax(dim=-1, keepdim=True)


def ffn_w8a8_down_plain(h, amax, wq_dn, s_dn, b_dn=None):
    """K2's down half in PyTorch (launches 3-4): h re-quantized per row with
    the rows' absmax ``amax`` (the whole row's) -> fp32 [M, H], the bias
    added where given."""
    h_q, s_h = row_quant_amax(h, amax)
    y = int_mm(h_q, wq_dn).float() * s_h * s_dn
    return y if b_dn is None else y + b_dn


def fused_ffn_w8a8_plain(x, wq_up, s_up, b_up, wq_dn, s_dn, b_dn, hidden_act="gelu"):
    """The kernel's arithmetic in PyTorch: x [M, H] -> [M, H] in x's dtype."""
    h, amax = ffn_w8a8_up_plain(x, wq_up, s_up, b_up, hidden_act)
    return ffn_w8a8_down_plain(h, amax, wq_dn, s_dn, b_dn).to(x.dtype)


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


def nk_weight(w_q: torch.Tensor) -> torch.Tensor:
    """An INT8 weight [..., K, N] as the [..., N, K] copy K2's tensor-core
    variant reads (k innermost: int8 mma.sync fragments hold four
    consecutive k, and ldmatrix has no 8-bit transpose)."""
    return w_q.transpose(-1, -2).contiguous()


def add_nk_weights(params: Params) -> Params:
    """``params`` with an [N, K] copy ("w_t", :func:`nk_weight`) beside each
    INT8 weight of the encoder's FFN ([L, K, N] stacked), for K2's
    tensor-core variant: 2 * H * I bytes a layer more on the device (56.6 MB
    for gliclass-base). Other trees, and trees that hold the copies already,
    are returned as they are."""
    ffn = params.get("backbone", {}).get("layers", {}).get("ffn")
    if not ffn or not all("w_q" in ffn.get(n, {}) and "w_t" not in ffn[n] for n in ("up", "down")):
        return params
    new_ffn = dict(ffn, **{n: dict(ffn[n], w_t=nk_weight(ffn[n]["w_q"])) for n in ("up", "down")})
    layers = dict(params["backbone"]["layers"], ffn=new_ffn)
    return dict(params, backbone=dict(params["backbone"], layers=layers))


def w8a8_tc_args(x, wt_up, s_up, b_up, wt_dn, s_dn, b_dn, out):
    """The arguments of K2's tensor-core C entry (checked tensors, ``out``
    [M, H] bf16) with fresh scratch, and the scratch tensors, which must
    outlive the call: x_q [M, H] and h_q [M, I] int8; h [M, I], s_x and s_h
    [M] fp32 (s_h also holds h's row absmax between launches 2 and 3)."""
    M, H = x.shape
    I = wt_up.shape[0]
    i8 = torch.empty(M * (H + I), dtype=torch.int8, device=x.device)
    f32 = torch.empty(M * (I + 2), dtype=torch.float32, device=x.device)
    h, s_x, s_h = f32.data_ptr(), f32.data_ptr() + 4 * M * I, f32.data_ptr() + 4 * (M * I + M)
    args = (x.data_ptr(), wt_up.data_ptr(), s_up.data_ptr(), b_up.data_ptr(), wt_dn.data_ptr(), s_dn.data_ptr(),
            b_dn.data_ptr(), i8.data_ptr(), s_x, h, i8.data_ptr() + M * H, s_h, out.data_ptr(), M, H, I,
            _build.stream_ptr(x))
    return args, (i8, f32)


def w8a8_tc_up(x, wt_up, s_up, b_up):
    """K2's tensor-core up half (launches 1-2) on checked, aligned tensors:
    (h fp32 [M, I], sh fp32 [M]: each row's max |h|, the scratch x_q and
    s_x)."""
    M, H = x.shape
    I = wt_up.shape[0]
    xq = torch.empty((M, H), dtype=torch.int8, device=x.device)
    sx, sh = (torch.empty(M, dtype=torch.float32, device=x.device) for _ in range(2))
    h = torch.empty((M, I), dtype=torch.float32, device=x.device)
    rc = _build.lib().gct_fused_ffn_w8a8_tc_up(
        x.data_ptr(), wt_up.data_ptr(), s_up.data_ptr(), b_up.data_ptr(), xq.data_ptr(), sx.data_ptr(),
        h.data_ptr(), sh.data_ptr(), M, H, I, _build.stream_ptr(x))
    _build.check(rc, "gct_fused_ffn_w8a8_tc_up")
    return h, sh, (xq, sx)


def w8a8_tc_down(h, sh, wt_dn, s_dn, b_dn=None, out_dtype=torch.float32):
    """K2's tensor-core down half (launches 3-4): h [M, I] re-quantized
    with the rows' absmax in ``sh`` (overwritten with the scales) -> (out
    [M, H] in ``out_dtype``, fp32 or bf16, the bias added where given; h_q
    int8 [M, I])."""
    M, I = h.shape
    H = wt_dn.shape[0]
    hq = torch.empty((M, I), dtype=torch.int8, device=h.device)
    out = torch.empty((M, H), dtype=out_dtype, device=h.device)
    rc = _build.lib().gct_fused_ffn_w8a8_tc_down(
        h.data_ptr(), wt_dn.data_ptr(), s_dn.data_ptr(), None if b_dn is None else b_dn.data_ptr(), hq.data_ptr(),
        sh.data_ptr(), out.data_ptr(), int(out_dtype == torch.float32), M, H, I, _build.stream_ptr(h))
    _build.check(rc, "gct_fused_ffn_w8a8_tc_down")
    return out, hq


def fused_ffn_w8a8(x, wq_up, s_up, b_up, wq_dn, s_dn, b_dn, hidden_act="gelu", wt_up=None, wt_dn=None, group=None):
    """Fused w8a8 FFN (K2). x: [M, H] bf16; wq_up int8 [H, I]; s_up, b_up f32
    [I]; wq_dn int8 [I, H]; s_dn, b_dn f32 [H]; wt_up, wt_dn: their [N, K]
    copies (:func:`nk_weight`), which the tensor-core variant reads and
    requires (a CUDA x only). The variant by :func:`kernel_variant`.
    ``group``: the model group whose ranks hold the other columns of I
    (split at s_h, module doc)."""
    _build.refuse_grad("fused_ffn_w8a8", x, s_up, b_up, s_dn, b_dn)
    split = group_size(group) > 1
    if not x.is_cuda:
        if not split:
            return fused_ffn_w8a8_plain(x, wq_up, s_up, b_up, wq_dn, s_dn, b_dn, hidden_act)
        h, amax = ffn_w8a8_up_plain(x, wq_up, s_up, b_up, hidden_act)
        y = ffn_w8a8_down_plain(h, all_reduce_max(amax, group), wq_dn, s_dn)
        return (reduce_from_model(y, group) + b_dn).to(x.dtype)
    global launches, launches_tc, launches_split
    args = (x, wq_up, s_up, b_up, wq_dn, s_dn, b_dn)
    M, H, I = _check_ffn_args("fused_ffn_w8a8", *args, hidden_act)
    tc = kernel_variant(H, I) == TENSOR_CORE
    if split and not tc:
        raise ValueError(
            f"fused_ffn_w8a8: under tensor parallelism K2 runs split at the intermediate's row scale, which only "
            f"its tensor-core variant can (H and the local I multiples of 16), got H={H}, I={I}"
        )
    if tc:
        for arg, t, shape in (("wt_up", wt_up, (I, H)), ("wt_dn", wt_dn, (H, I))):
            ok = t is not None and t.dtype == torch.int8 and tuple(t.shape) == shape
            if not (ok and t.is_contiguous() and t.device == x.device):
                raise ValueError(f"fused_ffn_w8a8: {arg} must be contiguous int8 {shape} on {x.device} (nk_weight)")
        # 16-byte copies of x and weight rows: realign a view that starts off a 16-byte boundary.
        x, wt_up, wt_dn = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (x, wt_up, wt_dn))
        if split:
            h, sh, _scratch = w8a8_tc_up(x, wt_up, s_up, b_up)
            y, _hq = w8a8_tc_down(h, all_reduce_max(sh, group), wt_dn, s_dn)
            out = (reduce_from_model(y, group) + b_dn).to(x.dtype)
        else:
            out = torch.empty_like(x)
            entry_args, _scratch = w8a8_tc_args(x, wt_up, s_up, b_up, wt_dn, s_dn, b_dn, out)
            _build.check(_build.lib().gct_fused_ffn_w8a8_tc(*entry_args), "gct_fused_ffn_w8a8_tc")
    else:
        out = _launch_ffn("gct_fused_ffn_w8a8", *args, M, H, I)
    launches += 1
    launches_tc += tc
    launches_split += split
    return out


def fused_ffn_wonly(x, wq_up, s_up, b_up, wq_dn, s_dn, b_dn, hidden_act="gelu", group=None):
    """Weight-only INT8 FFN (K4), same arguments as :func:`fused_ffn_w8a8`;
    the variant by :func:`kernel_variant`. ``group``: as there (the partial
    sums in x's dtype, summed in fp32, then the bias)."""
    _build.refuse_grad("fused_ffn_wonly", x, s_up, b_up, s_dn, b_dn)
    split = group_size(group) > 1
    b_k = torch.zeros_like(b_dn) if split else b_dn
    if not x.is_cuda:
        out = fused_ffn_wonly_plain(x, wq_up, s_up, b_up, wq_dn, s_dn, b_k, hidden_act)
        return (reduce_from_model(out, group) + b_dn).to(x.dtype) if split else out
    global launches_wonly, launches_wonly_tc
    args = (x, wq_up, s_up, b_up, wq_dn, s_dn, b_k)
    M, H, I = _check_ffn_args("fused_ffn_wonly", *args, hidden_act)
    tc = kernel_variant(H, I) == TENSOR_CORE
    if tc:
        # 16-byte copies of x and weight rows: realign a view that starts off a 16-byte boundary.
        x, wq_up, wq_dn = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (x, wq_up, wq_dn))
        h = torch.empty((M, I), dtype=x.dtype, device=x.device)
        out = torch.empty_like(x)
        rc = _build.lib().gct_fused_ffn_wonly_tc(
            x.data_ptr(), wq_up.data_ptr(), s_up.data_ptr(), b_up.data_ptr(), wq_dn.data_ptr(), s_dn.data_ptr(),
            b_k.data_ptr(), h.data_ptr(), out.data_ptr(), M, H, I, _build.stream_ptr(x),
        )
        _build.check(rc, "gct_fused_ffn_wonly_tc")
    else:
        out = _launch_ffn("gct_fused_ffn_wonly", *args, M, H, I)
    launches_wonly += 1
    launches_wonly_tc += tc
    return (reduce_from_model(out, group) + b_dn).to(x.dtype) if split else out


def _bias_f32(p: Params, n: int, like: torch.Tensor) -> torch.Tensor:
    b = p.get("b")
    return torch.zeros(n, dtype=torch.float32, device=like.device) if b is None else b.float()


def fused_ffn(p_up: Params, p_down: Params, x: torch.Tensor, hidden_act: str,
              compute_dtype: torch.dtype, group=None) -> torch.Tensor:
    """y = act(x @ up) @ down for x [..., H] (routing in the module doc).
    ``group``: the model group over which up's columns and down's rows are
    sharded (None: whole)."""
    quantized = "w_q" in p_up and "w_q" in p_down
    if quantized and compute_dtype != torch.float32:
        *lead, H = x.shape
        I = p_up["w_q"].shape[1]
        args = (
            x.reshape(-1, H).to(compute_dtype).contiguous(),
            p_up["w_q"], p_up["scale"].float(), _bias_f32(p_up, I, x),
            p_down["w_q"], p_down["scale"].float(), _bias_f32(p_down, H, x),
            hidden_act,
        )
        if act_quant_enabled():
            y = fused_ffn_w8a8(*args, wt_up=p_up.get("w_t"), wt_dn=p_down.get("w_t"), group=group)
        else:
            y = fused_ffn_wonly(*args, group=group)
        return y.reshape(*lead, H)
    # "gelu" is erf in fp32 and the tanh form in reduced precision (layers._gelu).
    h = activation(hidden_act)(linear(p_up, copy_to_model(x, group), compute_dtype))
    return row_linear(p_down, h, compute_dtype, group)
