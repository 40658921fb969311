"""Speed-of-light accounting on the card: analytic step cost against its peaks.

The port's counterpart of ``gliclass.c_tpu.utils.perf``. It prices a
GLiClass forward analytically (tensor-core operations and device-memory
bytes per component) and turns a measured time into rates and into a share
of the speed of light: the larger of the operations over the peak rate of
their type and the bytes over the memory rate.

The model counts first-order terms only (projection products, attention
contractions, score-tensor traffic, weight reads, activation passes, the
intermediates a kernel writes through device memory); elementwise epilogues
are not counted again. Attention is priced for the route the port takes at
the shape (``ops.fused_attention.attention_route``), the FFN for the kernel
that runs it (``ops.fused_ffn.kernel_variant``).

Peaks come from :data:`DEVICE_PEAKS`, keyed on ``torch.cuda.get_device_name()``;
a card that is not in it raises, as there is no default. The kernels' bounds
(:func:`kernel_bound_ms`) use the same table.
"""

from __future__ import annotations

import statistics
import time
from dataclasses import dataclass, field

import torch

from ..config import GLiClassConfig

# Published dense peaks (NVIDIA's data sheet, SXM part, without sparsity, at
# the full 700 W power limit): operations/s by operand type, and bytes/s of
# device memory.
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12, "hbm_bytes_per_s": 3.35e12},
}


def device_peaks(device_name: str | None = None) -> dict:
    """The peaks of ``device_name`` (default: the current CUDA card's name)."""
    name = torch.cuda.get_device_name() if device_name is None else device_name
    if name not in DEVICE_PEAKS:
        raise ValueError(f"no published peaks for the device {name!r} (known: {sorted(DEVICE_PEAKS)})")
    return DEVICE_PEAKS[name]


def kernel_bound_ms(ops: float, op_type: str, nbytes: float, device_name: str | None = None) -> tuple[float, str]:
    """The least time the card could take for a kernel's work: the larger of
    ``ops`` operations of ``op_type`` ("bf16", "int8", "fp32") over their
    peak rate and ``nbytes`` (each input read once, each output written
    once) over the memory rate -> (ms, "operations" | "bytes")."""
    peaks = device_peaks(device_name)
    t_ops = ops / peaks[op_type] * 1e3
    t_bytes = nbytes / peaks["hbm_bytes_per_s"] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _matmul_type(quant_mode: str) -> str:
    """The operand type of a bf16 forward's dense products: int8 x int8
    under w8a8 (``int8-dynamic``: ``torch._int_mm`` and K2's s8 products),
    else bf16 (K3 and K4 widen the INT8 weights to bf16)."""
    return "int8" if quant_mode == "int8-dynamic" else "bf16"


def _attention_type(cfg: GLiClassConfig) -> str:
    """The operand type of a bf16 forward's attention contractions: bf16 on
    the tensor-core kernels, fp32 on the CUDA-core ones (K5 at a head width
    that is not a multiple of 16, ``ops.causal_attention.kernel_variant``)."""
    from ..ops import causal_attention
    from ..ops.fused_attention import TENSOR_CORE

    bb = cfg.backbone
    if bb.model_type in ("llama", "qwen2"):
        return "bf16" if causal_attention.kernel_variant(torch.bfloat16, bb.head_dim) == TENSOR_CORE else "fp32"
    return "bf16"


@dataclass
class StepCost:
    """Per-step cost, broken down by component (operations) and class (bytes)."""

    flops: dict[str, float] = field(default_factory=dict)
    hbm_bytes: dict[str, float] = field(default_factory=dict)

    @property
    def total_flops(self) -> float:
        return sum(self.flops.values())

    @property
    def total_bytes(self) -> float:
        return sum(self.hbm_bytes.values())


def attn_route_for(cfg: GLiClassConfig, batch: int, seq: int, route: str = "auto", device="cuda") -> str:
    """The DeBERTa attention route of a [batch, seq] forward: the one
    ``models.deberta.deberta_encode`` takes ("flash", "bias", "row",
    "tiled" or "score"), by the same functions."""
    from ..models.deberta import kernel_route
    from ..ops.fused_attention import attention_route

    bb = cfg.backbone
    if not kernel_route(bb):
        return "score"
    return attention_route(seq, batch, bb.head_dim, route, device)


def _attn_path_extras(bb, batch: int, seq: int, act: int, route: str) -> tuple[float, float]:
    """Per-layer (extra operations, extra bytes) of the attention route,
    beyond the terms every route shares (projections, the q.k, p.v, c2p and
    p2c contractions). The bytes follow what each route writes through
    device memory:

      flash, row  q/k/v/o once (K1, K8 keep scores and biases on chip)
      bias        K6's two [h, S, d, S] tables written and read by the bias
                  products, their c2p/p2c [B, h, S, S] written and read by
                  K7, q/k/v/o once; K6 is a copy (no operations)
      tiled       K9's two windowed tables [h, 2n-1, blk, blk, d] written,
                  K10 reading each (query tile, key tile) block once (the
                  whole [h, S, S, d] table once), q/k/v/o once; K9 is a copy
      score       the materialized-score path (``score_attention``):
                  [B, h, S, S] scores (~4 passes) and the relative-axis
                  [B, h, S, 2S-1] c2p/p2c written and read
    """
    from ..ops.fused_attention import TILED_BLK

    B, S = batch, seq
    h, d = bb.num_attention_heads, bb.head_dim
    io = 4 * B * h * S * d * act
    if route in ("flash", "row"):
        return (0, io)
    if route == "bias":
        return (0, 4 * h * d * S * S * act + 4 * B * h * S * S * act + io)
    if route == "tiled":
        n_win = 2 * (S // TILED_BLK) - 1
        return (0, io + 2 * h * d * S * S * act + 2 * h * n_win * d * TILED_BLK * TILED_BLK * act)
    if route == "score":
        W = 2 * S - 1
        return (0, 4 * B * h * S * S * act + 2 * 2 * B * h * S * W * act)
    raise ValueError(f"unknown attention route {route!r}")


def _ffn_intermediate_bytes(H: int, I: int, M: int, quant_mode: str, act: int) -> float:
    """Bytes of the FFN's [M, I] intermediate through device memory, by the
    kernel that runs the FFN (``ops.fused_ffn``): K2's tensor-core variant
    writes its fp32 up product and reads it back (4·M·I·2); K4's writes and
    reads a bf16 one; their CUDA-core variants keep it on chip; plain
    linears (unquantized weights, or fp32) write and read it in the compute
    dtype."""
    from ..ops.fused_ffn import TENSOR_CORE, kernel_variant

    if act < 4 and quant_mode in ("int8", "int8-dynamic"):
        if kernel_variant(H, I) != TENSOR_CORE:
            return 0.0
        return 4 * M * I * 2 if quant_mode == "int8-dynamic" else 2 * M * I * act
    return 2 * M * I * act


def gliclass_step_cost(
    cfg: GLiClassConfig,
    batch: int,
    seq: int,
    quant_mode: str = "int8",
    compute_dtype_bytes: int = 2,
    route: str = "auto",
    device="cuda",
) -> StepCost:
    """Analytic cost of one [batch, seq] forward on one card. The terms the
    JAX package's model has are computed as it computes them; attention's
    extras follow the port's route at this shape (``route`` as
    ``RuntimeConfig.attn_route``, on ``device``), and ``ffn_intermediate``
    is the FFN kernel's [M, I] round trip."""
    bb = cfg.backbone
    H, I, L = bb.hidden_size, bb.intermediate_size, bb.num_hidden_layers
    h, d = bb.num_attention_heads, bb.head_dim
    B, S = batch, seq
    M = B * S  # tokens per step
    act = compute_dtype_bytes
    wbytes = 1 if quant_mode in ("int8", "int8-dynamic") else act

    if bb.model_type in ("llama", "qwen2"):
        return _causal_step_cost(cfg, batch, seq, quant_mode, act, wbytes, route)

    c = StepCost()
    c.flops["qkv_o_proj"] = L * 4 * 2 * M * H * H
    c.flops["ffn"] = L * 2 * 2 * M * H * I
    c.flops["attn_content_pv"] = L * 2 * 2 * B * h * S * S * d
    if bb.relative_attention:
        # c2p + p2c contractions (every route does these, in or out of a kernel)
        c.flops["attn_rel_bias"] = L * 2 * 2 * B * h * S * S * d
        # position projections of the [2K, H] bucket table (pos_q + pos_k)
        K2 = 2 * (bb.position_buckets if bb.position_buckets > 0 else S)
        c.flops["pos_proj"] = L * 2 * 2 * K2 * H * H
        extra_flops, extra_bytes = _attn_path_extras(bb, B, S, act, attn_route_for(cfg, B, S, route, device))
        if extra_flops:
            c.flops["attn_path"] = L * extra_flops
    # head: the two projector products over all tokens, an upper bound of
    # its batched form
    c.flops["head"] = 2 * 2 * M * H * H

    c.hbm_bytes["weights"] = L * (4 * H * H + 2 * H * I) * wbytes
    # residual stream: read + write per block, ~4 passes per layer
    c.hbm_bytes["activations"] = L * 4 * 2 * M * H * act
    c.hbm_bytes["ffn_intermediate"] = L * _ffn_intermediate_bytes(H, I, M, quant_mode, act)
    if bb.relative_attention:
        c.hbm_bytes["attn_path"] = L * extra_bytes
    c.hbm_bytes["embeddings"] = M * H * act  # gathered rows
    return c


def _causal_step_cost(cfg: GLiClassConfig, batch: int, seq: int, quant_mode: str, act: int, wbytes: int,
                      route: str = "auto") -> StepCost:
    """Cost terms of the Llama/Qwen2 decoder backbones (models/llama.py):
    GQA projections, the SwiGLU MLP (three products), and causal attention:
    K5 (either variant) keeps scores on chip, so its bytes are q/k/v/o
    once; the score path (``route`` "xla" or "table") writes and reads the
    [B, h, S, S] scores and probabilities."""
    bb = cfg.backbone
    H, I, L = bb.hidden_size, bb.intermediate_size, bb.num_hidden_layers
    h, d, kv = bb.num_attention_heads, bb.head_dim, bb.kv_heads
    B, S = batch, seq
    M = B * S

    c = StepCost()
    c.flops["qkv_o_proj"] = L * (
        2 * M * H * (h * d)  # q
        + 2 * 2 * M * H * (kv * d)  # k, v
        + 2 * M * (h * d) * H  # o
    )
    c.flops["ffn"] = L * 3 * 2 * M * H * I  # gate + up + down
    c.flops["attn_content_pv"] = L * 2 * 2 * B * h * S * S * d  # qk + pv
    c.flops["head"] = 2 * 2 * M * H * H  # projector upper bound (as the encoder)

    c.hbm_bytes["weights"] = L * ((2 * H * h * d + 2 * H * kv * d + 3 * H * I) * wbytes)
    c.hbm_bytes["activations"] = L * 4 * 2 * M * H * act
    if route in ("xla", "table"):
        c.hbm_bytes["attn_scores"] = L * 4 * B * h * S * S * act
    else:
        c.hbm_bytes["attn_scores"] = L * 2 * B * (h + kv) * S * d * act
    c.hbm_bytes["embeddings"] = M * H * act
    return c


# ---------------------------------------------------------------------------
# Per-component measurement against the speed of light
# ---------------------------------------------------------------------------
def _component_costs(cfg: GLiClassConfig, batch: int, seq: int, quant_mode: str, act: int,
                     route: str = "auto", device="cuda") -> dict[str, tuple[float, float]]:
    """Per-layer (operations, bytes) of each probe of :func:`per_kernel_report`,
    from the terms of :func:`gliclass_step_cost`, so that a probe's share and
    a whole step's share come from one model."""
    bb = cfg.backbone
    H, I = bb.hidden_size, bb.intermediate_size
    h, d = bb.num_attention_heads, bb.head_dim
    B, S = batch, seq
    M = B * S
    wb = 1 if quant_mode in ("int8", "int8-dynamic") else act

    if bb.model_type in ("llama", "qwen2"):
        cc = _causal_step_cost(cfg, B, S, quant_mode, act, wb, route)
        L, kv = bb.num_hidden_layers, bb.kv_heads
        proj_w = (2 * H * h * d + 2 * H * kv * d) * wb
        return {
            "qkv_o_proj": (cc.flops["qkv_o_proj"] / L, proj_w + 8 * M * H * act),
            # SwiGLU: three weights, x in and y out, and the [M, I] gate/up
            # products written and read (~4 passes)
            "ffn": (cc.flops["ffn"] / L, 3 * H * I * wb + 2 * M * H * act + 4 * M * I * act),
            "attn_total": (
                cc.flops["qkv_o_proj"] / L + cc.flops["attn_content_pv"] / L,
                proj_w + 8 * M * H * act + cc.hbm_bytes["attn_scores"] / L,
            ),
        }

    K2 = 2 * (bb.position_buckets if bb.position_buckets > 0 else S)
    qkv_o = (4 * 2 * M * H * H, 4 * H * H * wb + 8 * M * H * act)
    ffn = (2 * 2 * M * H * I, 2 * H * I * wb + 2 * M * H * act + _ffn_intermediate_bytes(H, I, M, quant_mode, act))
    attn_flops = 4 * 2 * M * H * H + 2 * 2 * B * h * S * S * d  # projections + qk/pv
    attn_bytes = 4 * H * H * wb + 8 * M * H * act
    if bb.relative_attention:
        attn_flops += 2 * 2 * B * h * S * S * d  # c2p + p2c
        attn_flops += 2 * 2 * K2 * H * H  # position projections
        extra_flops, extra_bytes = _attn_path_extras(bb, B, S, act, attn_route_for(cfg, B, S, route, device))
        attn_flops += extra_flops
        attn_bytes += extra_bytes
    return {"qkv_o_proj": qkv_o, "ffn": ffn, "attn_total": (attn_flops, attn_bytes)}


def _time_chain(fn, x, iters: int, device: torch.device) -> float:
    """ms per call of ``fn``, each call fed the previous call's output:
    the median over five chains of ``iters`` calls, after three warm calls.
    On a CUDA device CUDA events around each chain; on the CPU the host
    clock."""
    y = x
    for _ in range(3):
        y = fn(y)
    times = []
    for _ in range(5):
        y = x
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                y = fn(y)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / iters)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                y = fn(y)
            times.append((time.perf_counter() - t0) * 1e3 / iters)
    return statistics.median(times)


def per_kernel_report(
    cfg: GLiClassConfig,
    batch: int,
    seq: int,
    quant_mode: str = "int8",
    device="cuda",
    device_name: str | None = None,
    iters: int = 20,
    route: str = "auto",
) -> list[dict]:
    """Time each hot component of one layer at the step's shapes in bf16
    and price it against its own speed of light on ``device_name``'s peaks
    (default: the name of ``device``, which must then be a CUDA card).

    The components are the port's real building blocks with random INT8
    (or bf16) weights: the q/k/v/o projections (``ops.layers.linear``:
    ``torch._int_mm`` under ``int8-dynamic``, K3 under ``int8``), the FFN
    (``ops.fused_ffn.fused_ffn``: K2 or K4; a decoder's SwiGLU through
    ``models.llama.llama_mlp``) and the attention block
    (``models.deberta.disentangled_attention`` on the route the model
    takes at this shape, or ``models.llama.llama_attention``: K5).
    ``int8-dynamic`` runs them inside ``act_quant`` as the engine does.

    Each probe runs as a chain whose output feeds the next call; its ms
    is the median chain's time per call (:func:`_time_chain`): CUDA events
    on a card, the host clock on the CPU (``"clock"`` says which)."""
    from ..models import deberta as D
    from ..models import llama as LL
    from ..ops.fused_ffn import fused_ffn, nk_weight
    from ..ops.layers import act_quant, linear
    from ..ops.quant import quantize_dense_param

    device = torch.device(device)
    if device_name is None:
        if device.type != "cuda":
            raise ValueError("per_kernel_report: pass device_name to price a run on a device that is not a card")
        device_name = torch.cuda.get_device_name(device)
    peaks = device_peaks(device_name)
    bb = cfg.backbone
    H, I = bb.hidden_size, bb.intermediate_size
    h, d = bb.num_attention_heads, bb.head_dim
    B, S, M = batch, seq, batch * seq
    dtype, act = torch.bfloat16, 2
    quantized = quant_mode in ("int8", "int8-dynamic")
    gen = torch.Generator().manual_seed(0)

    def normal(*shape, std=1.0):
        return torch.randn(shape, generator=gen) * std

    def dense(k_in: int, k_out: int, nk: bool = False) -> dict:
        w = normal(k_in, k_out, std=0.02)
        if not quantized:
            return {"w": w.to(device, dtype)}
        p = {k: torch.from_numpy(v).to(device) for k, v in quantize_dense_param({"w": w.numpy()}).items()}
        if nk and quant_mode == "int8-dynamic" and device.type == "cuda":
            p["w_t"] = nk_weight(p["w_q"])  # the [N, K] copy K2's tensor-core variant reads
        return p

    x = normal(M, H).to(device, dtype)
    xs = normal(B, S, H).to(device, dtype)
    key_mask = torch.ones((B, S), dtype=torch.int32, device=device)
    attn_route = None
    if bb.model_type in ("llama", "qwen2"):
        kv = bb.kv_heads
        p_attn = {"q": dense(H, h * d), "k": dense(H, kv * d), "v": dense(H, kv * d), "o": dense(h * d, H)}
        p_mlp = {"gate": dense(H, I), "up": dense(H, I), "down": dense(I, H)}
        cos, sin = LL.rope_device(S, d, float(bb.rope_theta), str(device))
        score = route in ("xla", "table")
        mask_bias = LL.causal_mask_bias(key_mask) if score else None
        pad = torch.zeros((M, H - kv * d), dtype=dtype, device=device)

        def probe_qkv_o(x):
            y = linear(p_attn["o"], linear(p_attn["q"], x, dtype), dtype)
            return (y + torch.cat([linear(p_attn["k"], x, dtype), pad], -1)
                    + torch.cat([linear(p_attn["v"], x, dtype), pad], -1))

        def probe_ffn(x):
            return LL.llama_mlp(p_mlp, x, dtype)

        def probe_attn(xs):
            if score:
                return LL.score_attention(p_attn, xs, mask_bias, cos, sin, bb, dtype)
            return LL.llama_attention(p_attn, xs, key_mask, cos, sin, bb, dtype)

        attn_route = "score" if score else "causal"
    else:
        p_attn = {n: dense(H, H) for n in ("q", "k", "v", "o")}
        p_up, p_down = dense(H, I, nk=True), dense(I, H, nk=True)
        max_rel = bb.max_relative_positions if bb.max_relative_positions >= 1 else bb.max_position_embeddings
        span = bb.position_buckets if bb.position_buckets > 0 else max_rel
        c2p_np, p2c_np = D.rel_bias_columns(S, span, bb.position_buckets, max_rel)
        c2p = torch.from_numpy(c2p_np.astype("int64")).to(device)
        p2c = torch.from_numpy(p2c_np.astype("int64")).to(device)
        rel_emb = normal(2 * span, H).to(device, dtype)
        pair_mask = torch.ones((B, S, S), dtype=torch.bool, device=device)
        attn_route = attn_route_for(cfg, B, S, route, device)

        def probe_qkv_o(x):
            return (linear(p_attn["o"], linear(p_attn["v"], x, dtype), dtype) + linear(p_attn["k"], x, dtype)
                    + linear(p_attn["q"], x, dtype))

        def probe_ffn(x):
            return fused_ffn(p_up, p_down, x, bb.hidden_act, dtype)

        def probe_attn(xs):
            if attn_route == "score":
                return D.score_attention(p_attn, xs, rel_emb, pair_mask, c2p, p2c, bb, dtype)
            return D.disentangled_attention(p_attn, xs, rel_emb, c2p, p2c, bb, dtype, key_mask, attn_route)

    costs = _component_costs(cfg, B, S, quant_mode, act, route, device)
    mm, att = peaks[_matmul_type(quant_mode)], peaks[_attention_type(cfg)]
    # The attention block's dense products (projections, position
    # projections) at the products' peak, its contractions at attention's.
    if bb.model_type in ("llama", "qwen2"):
        dense_attn = 2 * M * H * (h * d) + 2 * 2 * M * H * (bb.kv_heads * d) + 2 * M * (h * d) * H
    else:
        dense_attn = 4 * 2 * M * H * H + (2 * 2 * (2 * span) * H * H if bb.relative_attention else 0)
    rows = []
    with torch.inference_mode(), act_quant(quant_mode == "int8-dynamic"):
        for name, fn, arg in (("qkv_o_proj", probe_qkv_o, x), ("ffn", probe_ffn, x), ("attn_total", probe_attn, xs)):
            ms = _time_chain(fn, arg, iters, device)
            flops, nbytes = costs[name]
            if name == "attn_total":
                compute_s = min(dense_attn, flops) / mm + max(flops - dense_attn, 0.0) / att
            else:
                compute_s = flops / mm
            bytes_s = nbytes / peaks["hbm_bytes_per_s"]
            sol_ms = max(compute_s, bytes_s) * 1e3
            rows.append({
                "component": name, "ms": ms, "sol_ms": sol_ms, "sol_frac": sol_ms / ms if ms > 0 else 0.0,
                "bound_by": "operations" if compute_s >= bytes_s else "bytes",
                "tflops": flops / (ms * 1e-3) / 1e12, "gbps": nbytes / (ms * 1e-3) / 1e9,
                "clock": "cuda events" if device.type == "cuda" else "host",
                "route": attn_route if name == "attn_total" else None,
            })
    return rows


def format_kernel_report(rows: list[dict]) -> str:
    head = f"{'component':<12} {'ms':>9} {'sol_ms':>9} {'sol_frac':>8} {'tflops':>8} {'gbps':>8}  bound by"
    lines = [head]
    for r in rows:
        lines.append(
            f"{r['component']:<12} {r['ms']:>9.4f} {r['sol_ms']:>9.4f} {r['sol_frac']:>8.3f} "
            f"{r['tflops']:>8.1f} {r['gbps']:>8.1f}  {r['bound_by']}"
            + (f" (route {r['route']})" if r.get("route") else "")
        )
    return "\n".join(lines)


def speed_of_light(
    cfg: GLiClassConfig,
    batch: int,
    seq: int,
    step_seconds: float,
    device_name: str | None = None,
    quant_mode: str = "int8",
    route: str = "auto",
) -> dict:
    """A measured time of a bf16 forward -> achieved operations/s and
    bytes/s, their shares of the peaks, and the speed of light of the
    [batch, seq] forward on ``device_name`` (default: the current card): the
    larger of the operations over their peaks (dense products at the quant
    mode's type, attention's contractions at theirs) and the bytes over the
    memory rate."""
    name = torch.cuda.get_device_name() if device_name is None else device_name
    peaks = device_peaks(name)
    cost = gliclass_step_cost(cfg, batch, seq, quant_mode, 2, route)
    mm, att = peaks[_matmul_type(quant_mode)], peaks[_attention_type(cfg)]
    dense_keys = {"qkv_o_proj", "ffn", "pos_proj", "head"}
    compute_s = sum(v / (mm if k in dense_keys else att) for k, v in cost.flops.items())
    bytes_s = cost.total_bytes / peaks["hbm_bytes_per_s"]
    sol_s = max(compute_s, bytes_s)
    flops_per_s = cost.total_flops / step_seconds
    bytes_per_s = cost.total_bytes / step_seconds
    return {
        "device": name,
        "step_ms": step_seconds * 1e3,
        "tflops": flops_per_s / 1e12,
        "bf16_util": flops_per_s / peaks["bf16"],
        "hbm_gbps": bytes_per_s / 1e9,
        "hbm_util": bytes_per_s / peaks["hbm_bytes_per_s"],
        "sol_ms": sol_s * 1e3,
        "sol_frac": sol_s / step_seconds,
        "bound_by": "operations" if compute_s >= bytes_s else "bytes",
        "gflops": {k: v / 1e9 for k, v in cost.flops.items()},
        "gbytes": {k: v / 1e9 for k, v in cost.hbm_bytes.items()},
    }
