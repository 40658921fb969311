"""Smoke run of the PyTorch port on one CUDA card (H100, sm_90a).

    python3 chip_smoke.py [--seed N]

Phases, in order, each with its wall time; any failure exits non-zero:

1. Device: the card's name and power limit; builds the CUDA kernels from
   gliclass/c_tpu_torch/csrc/ (build time printed).
2. Kernels against their plain PyTorch versions on the card, at main-path
   shapes, with stated tolerances; kernel, plain and library times (CUDA
   events, median of 20 after warm-up) and each kernel's bound: the larger
   of its operations over the card's peak for their type and its bytes
   (each input read once, each output written once) over the HBM rate.
   K1 flash disentangled attention, K2 fused w8a8 FFN, K3 INT8-weight
   matmul, K4 fused weight-only FFN, K5 causal GQA flash attention, K6 the
   bias route's absolute position table (exact), K7 its softmax over
   precomputed biases.
3. DeBERTa main path, full width: gliclass-base (DeBERTa-v3-base, 12 layers,
   H=768, vocab 128,100) with random weights made from --seed,
   INT8-quantized, run through ZeroShotClassificationPipeline.classify_job
   in bf16 "int8-dynamic"; texts/s (median of 3 passes), stage timings,
   launch counts of K1 and K2 (reset just before the pass, read just
   after), a torch.profiler breakdown of device time by kernel, peak device
   memory, and agreement of the first 8 texts with the same port on the CPU.
4. Weight-only path: the same model and a subset of the job in "int8"; the
   launch counts of K4 (12 per forward) and K3, agreement with the CPU.
5. The two DeBERTa attention routes on the same model, "int8-dynamic":
   the whole forward at [128, 512] and [16, 512] with the route forced to
   flash (K1) and to bias (K6 + bias products + K7), classify_job texts/s on
   128 texts of the 512 bucket at batch 128, launches (K6 24 and K7 12 per
   forward, K1 none on the bias run), peak memory, a profile of the bias
   run, and fp32 hidden states bias against flash (1e-4).
6. Serve path: GLiClassServer on 127.0.0.1 (the same model, attn_route
   "bias", warmed up), 16 client threads posting 256 requests over HTTP;
   each answered once, scores against classify_job, K6/K7 launches per
   forward, /metrics latency percentiles and requests/s.
7. Decoder main path, full width and depth: gliclass-qwen-1.5B (Qwen2-1.5B,
   28 layers, H=1536, 12 query / 2 kv heads, d=128, I=8960, vocab 151,936),
   random INT8 weights made layer by layer, "int8-dynamic" through
   classify_job; texts/s, stages, profile, peak memory; K5 launched 28 times
   per forward; the first 4 texts against the CPU.
8. Llama-1.3B geometry at full width and 4 of its 24 layers (g=1, no q/k/v
   bias, vocab 32,000), "int8-dynamic", a small job; K5 launches and
   agreement with the CPU.
9. One JSON line of kernel records, the card line, and the final status line.

Needs torch, numpy and the CUDA toolkit (nvcc); no JAX, no network.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import re
import statistics
import subprocess
import sys
import time
import zlib

import numpy as np
import torch

# fp32 matmuls and convolutions in full fp32 on the card (no TF32), as the
# port's engine sets too.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# Published H100 SXM peaks (dense): bytes/s of HBM3 and operations/s by type.
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "fp32": 67e12, "int8": 1979e12}

SEQ_LADDER = (56, 72, 88, 104, 120, 128, 192, 256, 384, 512)


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of one call, by CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(ops: float, op_type: str, nbytes: float) -> tuple[float, str]:
    t_ops = ops / PEAK_OPS[op_type] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
def check_attention(gen: torch.Generator, dev) -> dict:
    from gliclass.c_tpu_torch.ops import fused_attention as FA

    h, d = 12, 64
    H = h * d
    scale = math.sqrt(d * 3)
    tol = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
    worst = 0.0
    tot = dict(ms=0.0, plain_ms=0.0, ops=0.0, nbytes=0.0)
    # (rows, bucket) as the main path launches them: full 128-row batches of
    # short prompts, and the 16 long texts of the 512 bucket.
    for B, S in ((128, 56), (128, 128), (16, 512)):
        for dtype in (torch.float32, torch.bfloat16):
            # q/k/v as head-split views of one fused [B, S, 3H] projection,
            # the layout the model passes.
            qkv = torch.randn(B, S, 3 * H, generator=gen, device=dev).to(dtype)
            q, k, v = (qkv[..., i * H:(i + 1) * H].reshape(B, S, h, d).transpose(1, 2) for i in range(3))
            pos_k = torch.randn(h, 2 * S - 1, d, generator=gen, device=dev).to(dtype)
            pos_q = torch.randn(h, 2 * S - 1, d, generator=gen, device=dev).to(dtype)
            lengths = torch.randint(1, S + 1, (B,), generator=gen, device=dev)
            lengths[0] = S
            mask = (torch.arange(S, device=dev)[None, :] < lengths[:, None]).to(torch.int32)
            out = FA.flash_disentangled_attention(q, k, v, pos_k, pos_q, mask, scale)
            ref = FA.flash_disentangled_attention_plain(q, k, v, pos_k, pos_q, mask, scale)
            torch.cuda.synchronize()
            if not torch.isfinite(out.float()).all():
                fail(f"K1 S={S} {dtype}: non-finite output")
            err = (out.float() - ref.float()).abs().max().item()
            log(f"K1 flash_disentangled_attention B={B} h={h} S={S} d={d} {str(dtype)[6:]}: "
                f"max|kernel-plain|={err:.3e} (tol {tol[dtype]:.0e})")
            if err > tol[dtype]:
                fail(f"K1 S={S} {dtype}: max error {err} above {tol[dtype]}")
            if dtype != torch.bfloat16:
                continue
            worst = max(worst, err)
            ms = time_ms(lambda: FA.flash_disentangled_attention(q, k, v, pos_k, pos_q, mask, scale))
            plain = time_ms(lambda: FA.flash_disentangled_attention_plain(q, k, v, pos_k, pos_q, mask, scale), iters=10)
            # Work the function needs: qk, c2p, p2c and P.v, 2*S*S*d each.
            ops = B * h * 8.0 * S * S * d
            nbytes = 4 * B * h * S * d * 2 + 2 * h * (2 * S - 1) * d * 2 + B * S * 4
            bms, by = bound_ms(ops, "bf16", nbytes)
            log(f"   time: kernel {ms:.4f} ms | plain {plain:.4f} ms | bound {bms:.4f} ms ({by})")
            for key, val in (("ms", ms), ("plain_ms", plain), ("ops", ops), ("nbytes", nbytes)):
                tot[key] += val
    bms, by = bound_ms(tot["ops"], "bf16", tot["nbytes"])
    return dict(ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=bms, bound_by=by, max_abs_err=worst,
                shape="sum of B=128 S=56, B=128 S=128, B=16 S=512 (h=12 d=64 bf16)")


def check_ffn(gen: torch.Generator, dev, rng: np.random.Generator) -> dict:
    from gliclass.c_tpu_torch.ops import fused_ffn as FF
    from gliclass.c_tpu_torch.ops.quant import quantize_weight

    M, H, I = 8192, 768, 3072
    wu, su = quantize_weight(rng.normal(0, 0.02, (H, I)).astype(np.float32))
    wd, sd = quantize_weight(rng.normal(0, 0.02, (I, H)).astype(np.float32))
    t = lambda a: torch.from_numpy(a).to(dev)
    wu, su, wd, sd = t(wu), t(su), t(wd), t(sd)
    bu = t(rng.normal(0, 0.02, I).astype(np.float32))
    bd = t(rng.normal(0, 0.02, H).astype(np.float32))
    x = torch.randn(M, H, generator=gen, device=dev).to(torch.bfloat16)
    args = (x, wu, su, bu, wd, sd, bd, "gelu")
    out = FF.fused_ffn_w8a8(*args)
    ref = FF.fused_ffn_w8a8_plain(*args)
    torch.cuda.synchronize()
    if not torch.isfinite(out.float()).all():
        fail("K2: non-finite output")
    err = (out.float() - ref.float()).abs().max().item()
    scale_ref = ref.float().abs().max().item()
    # bf16 output: a few ulps at the output's magnitude, plus the rare int8
    # re-quantization flip where the kernel's and PyTorch's tanh differ.
    tol = 4 * 2.0 ** (math.floor(math.log2(scale_ref)) - 7)
    log(f"K2 fused_ffn_w8a8 M={M} H={H} I={I}: max|kernel-plain|={err:.3e} "
        f"(tol {tol:.3e}, max|y| {scale_ref:.3f})")
    if err > tol:
        fail(f"K2: max error {err} above {tol}")
    ms = time_ms(lambda: FF.fused_ffn_w8a8(*args))
    plain = time_ms(lambda: FF.fused_ffn_w8a8_plain(*args), iters=10)
    ops = 4.0 * M * H * I
    nbytes = M * H * 2 * 2 + 2 * H * I + (I + H) * 4 * 2
    bms, by = bound_ms(ops, "int8", nbytes)
    log(f"   time: kernel {ms:.4f} ms | plain {plain:.4f} ms | bound {bms:.4f} ms ({by})")
    return dict(ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, max_abs_err=err,
                shape=f"M={M} H={H} I={I}")


def check_int8_matmul(gen: torch.Generator, dev, rng: np.random.Generator) -> dict:
    from gliclass.c_tpu_torch.ops import int8_matmul as IM
    from gliclass.c_tpu_torch.ops.quant import quantize_weight

    M = 8192
    shapes = {"qkv": (768, 2304), "o": (768, 768), "up": (768, 3072), "down": (3072, 768)}
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, ops=0.0, nbytes=0.0)
    worst = 0.0
    for name, (K, N) in shapes.items():
        w_q, scale = quantize_weight(rng.normal(0, 0.02, (K, N)).astype(np.float32))
        w_q, scale = torch.from_numpy(w_q).to(dev), torch.from_numpy(scale).to(dev)
        bias = torch.from_numpy(rng.normal(0, 0.02, N).astype(np.float32)).to(dev)
        x = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
        out = IM.int8_matmul(x, w_q, scale, bias)
        ref = IM.int8_matmul_plain(x, w_q, scale, bias)
        torch.cuda.synchronize()
        if not torch.isfinite(out.float()).all():
            fail(f"K3 {name}: non-finite output")
        err = (out.float() - ref.float()).abs().max().item()
        mx = ref.float().abs().max().item()
        # Same fp32 sum in another order, rounded once to bf16: 1 ulp.
        tol = 2.0 ** (math.floor(math.log2(mx)) - 7)
        log(f"K3 int8_matmul {name} M={M} K={K} N={N}: max|kernel-plain|={err:.3e} (tol {tol:.3e})")
        if err > tol:
            fail(f"K3 {name}: max error {err} above {tol}")
        worst = max(worst, err)
        w_deq = (w_q.float() * scale).to(torch.bfloat16)  # yardstick only
        ms = time_ms(lambda: IM.int8_matmul(x, w_q, scale, bias))
        plain = time_ms(lambda: IM.int8_matmul_plain(x, w_q, scale, bias), iters=10)
        lib = time_ms(lambda: torch.matmul(x, w_deq))
        ops, nbytes = 2.0 * M * N * K, M * K * 2 + K * N + N * 8 + M * N * 2
        bms, by = bound_ms(ops, "bf16", nbytes)
        log(f"   time: kernel {ms:.4f} ms | plain {plain:.4f} ms | torch.matmul(bf16 dequantized) "
            f"{lib:.4f} ms | bound {bms:.4f} ms ({by})")
        for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib), ("ops", ops), ("nbytes", nbytes)):
            tot[key] += val
    bms, by = bound_ms(tot["ops"], "bf16", tot["nbytes"])
    return dict(ms=tot["ms"], plain_ms=tot["plain_ms"], library_ms=tot["library_ms"],
                bound_ms=bms, bound_by=by, max_abs_err=worst,
                shape=f"sum of qkv, o, up, down at M={M}")


def check_ffn_wonly(gen: torch.Generator, dev, rng: np.random.Generator) -> dict:
    from gliclass.c_tpu_torch.ops import fused_ffn as FF
    from gliclass.c_tpu_torch.ops.quant import quantize_weight

    M, H, I = 8192, 768, 3072
    wu, su = quantize_weight(rng.normal(0, 0.02, (H, I)).astype(np.float32))
    wd, sd = quantize_weight(rng.normal(0, 0.02, (I, H)).astype(np.float32))
    t = lambda a: torch.from_numpy(a).to(dev)
    bu = t(rng.normal(0, 0.02, I).astype(np.float32))
    bd = t(rng.normal(0, 0.02, H).astype(np.float32))
    x = torch.randn(M, H, generator=gen, device=dev).to(torch.bfloat16)
    args = (x, t(wu), t(su), bu, t(wd), t(sd), bd, "gelu")
    out = FF.fused_ffn_wonly(*args)
    ref = FF.fused_ffn_wonly_plain(*args)
    torch.cuda.synchronize()
    if not torch.isfinite(out.float()).all():
        fail("K4: non-finite output")
    err = (out.float() - ref.float()).abs().max().item()
    scale_ref = ref.float().abs().max().item()
    # bf16 output: a few ulps at the output's magnitude; the fp32 sums differ
    # in order, which can move one bf16 step of the rounded intermediate.
    tol = 4 * 2.0 ** (math.floor(math.log2(scale_ref)) - 7)
    log(f"K4 fused_ffn_wonly M={M} H={H} I={I}: max|kernel-plain|={err:.3e} "
        f"(tol {tol:.3e}, max|y| {scale_ref:.3f})")
    if err > tol:
        fail(f"K4: max error {err} above {tol}")
    ms = time_ms(lambda: FF.fused_ffn_wonly(*args))
    plain = time_ms(lambda: FF.fused_ffn_wonly_plain(*args), iters=10)
    ops = 4.0 * M * H * I
    nbytes = M * H * 2 * 2 + 2 * H * I + (I + H) * 4 * 2
    bms, by = bound_ms(ops, "bf16", nbytes)
    log(f"   time: kernel {ms:.4f} ms | plain {plain:.4f} ms | bound {bms:.4f} ms ({by}) | "
        "library: none (no one PyTorch call computes up, gelu and down)")
    return dict(ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, max_abs_err=err,
                shape=f"M={M} H={H} I={I}")


def check_causal(gen: torch.Generator, dev) -> dict:
    from gliclass.c_tpu_torch.ops import causal_attention as CA

    d = 128
    tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, ops=0.0, nbytes=0.0)
    worst = 0.0
    lib_ok = True
    # (label, B, nkv, g, S, timed): the qwen main path's two shapes (full
    # 64-row batches of short prompts up to the 128 bucket, the 16 long texts
    # of the 512 bucket), the llama geometry (g = 1), and a ragged bucket.
    cases = (("qwen", 64, 2, 6, 128, True), ("qwen", 16, 2, 6, 512, True),
             ("llama", 16, 16, 1, 512, False), ("qwen ragged", 64, 2, 6, 88, False))
    for label, B, nkv, g, S, timed in cases:
        nh = nkv * g
        for dtype in (torch.float32, torch.bfloat16):
            # q as head views of a [B, S, nh*d] projection, as the model passes it.
            q = torch.randn(B, S, nh * d, generator=gen, device=dev).to(dtype)
            qg = q.reshape(B, S, nkv, g, d).permute(0, 2, 3, 1, 4)
            k, v = (torch.randn(B, nkv, S, d, generator=gen, device=dev).to(dtype) for _ in range(2))
            lengths = torch.randint(1, S + 1, (B,), generator=gen, device=dev)
            lengths[0], lengths[1] = S, 1  # a full row and a padded batch row
            mask = (torch.arange(S, device=dev)[None, :] < lengths[:, None]).to(torch.int32)
            scale = 1.0 / math.sqrt(d)
            out = CA.causal_flash_attention(qg, k, v, mask, scale)
            ref = CA.causal_flash_attention_plain(qg, k, v, mask, scale)
            torch.cuda.synchronize()
            if not torch.isfinite(out.float()).all():
                fail(f"K5 {label} S={S} {dtype}: non-finite output")
            err = (out.float() - ref.float()).abs().max().item()
            log(f"K5 causal_flash_attention {label} B={B} nkv={nkv} g={g} S={S} d={d} "
                f"{str(dtype)[6:]}: max|kernel-plain|={err:.3e} (tol {tol[dtype]:.0e})")
            if err > tol[dtype]:
                fail(f"K5 {label} S={S} {dtype}: max error {err} above {tol[dtype]}")
            if dtype != torch.bfloat16 or not timed:
                continue
            worst = max(worst, err)
            ms = time_ms(lambda: CA.causal_flash_attention(qg, k, v, mask, scale))
            plain = time_ms(lambda: CA.causal_flash_attention_plain(qg, k, v, mask, scale), iters=5)
            # Yardstick only: one PyTorch call for the same function.
            q4 = qg.reshape(B, nh, S, d)
            causal = torch.ones(S, S, dtype=torch.bool, device=dev).tril()
            amask = causal[None, None] & (mask > 0)[:, None, None, :]
            sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
                q4, k, v, attn_mask=amask, enable_gqa=True)
            try:
                lib = time_ms(sdpa)
            except TypeError as e:  # a PyTorch without enable_gqa
                lib_ok = False
                lib = float("nan")
                log(f"   library: scaled_dot_product_attention(enable_gqa=True) unavailable: {e}")
            # Work this data needs: q.k and P.v over the valid keys j <= i of
            # every query row, 2 operations per multiply-add.
            pairs = float(mask.cumsum(dim=1).sum().item())
            ops = 4.0 * d * nh * pairs
            nbytes = (2 * B * nh * S * d + 2 * B * nkv * S * d) * 2 + B * S * 4
            bms, by = bound_ms(ops, "bf16", nbytes)
            log(f"   time: kernel {ms:.4f} ms | plain {plain:.4f} ms | "
                f"scaled_dot_product_attention(enable_gqa) {lib:.4f} ms | bound {bms:.4f} ms ({by})")
            for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib), ("ops", ops),
                             ("nbytes", nbytes)):
                tot[key] += val
    bms, by = bound_ms(tot["ops"], "bf16", tot["nbytes"])
    return dict(ms=tot["ms"], plain_ms=tot["plain_ms"], library_ms=tot["library_ms"] if lib_ok else None,
                bound_ms=bms, bound_by=by, max_abs_err=worst,
                shape="sum of B=64 S=128, B=16 S=512 (nkv=2 g=6 d=128 bf16)")


def check_abs_pos_table(gen: torch.Generator, dev) -> dict:
    from gliclass.c_tpu_torch.ops import fused_attention as FA

    h, d = 12, 64
    rec = None
    for S in (88, 128, 512):
        for dtype in (torch.float32, torch.bfloat16):
            pos = torch.randn(h, 2 * S - 1, d, generator=gen, device=dev).to(dtype)
            out = FA.abs_pos_table(pos, S)
            ref = FA.abs_pos_table_plain(pos, S)
            torch.cuda.synchronize()
            # A copy of values: the kernel must equal the gather exactly.
            same = out.shape == ref.shape and torch.equal(out, ref)
            err = 0.0 if same else float("inf")
            if out.shape == ref.shape:
                err = (out.float() - ref.float()).abs().max().item()
            log(f"K6 abs_pos_table h={h} S={S} d={d} {str(dtype)[6:]}: "
                f"{'equal' if same else 'DIFFERENT'} to its plain version (max|diff| {err:.3e}, tol 0: exact)")
            if not same:
                fail(f"K6 S={S} {dtype}: kernel differs from its plain version")
            if S != 512 or dtype != torch.bfloat16:
                continue
            idx = FA.rel_index(S, dev)
            ms = time_ms(lambda: FA.abs_pos_table(pos, S))
            plain = time_ms(lambda: FA.abs_pos_table_plain(pos, S), iters=10)
            lib = time_ms(lambda: pos[:, idx])  # one gather, [h, S, S, d] layout
            nbytes = h * (2 * S - 1) * d * 2 + h * S * S * d * 2
            bms, by = bound_ms(0.0, "bf16", nbytes)
            log(f"   time: kernel {ms:.4f} ms | plain {plain:.4f} ms | pos_rel[:, idx] {lib:.4f} ms | "
                f"bound {bms:.4f} ms ({by}, {nbytes / 1e6:.1f} MB)")
            rec = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bms, bound_by=by, max_abs_err=err,
                       shape=f"one table, h={h} S={S} d={d} bf16")
    return rec


def bias_inputs(gen: torch.Generator, dev, B: int, S: int, dtype, ragged: bool):
    """K7's inputs as the bias route passes them: q/k/v head views of one
    [B, S, 3H] projection; c2p and p2c as views of [h, S, B, S] products
    (c2p contiguous in j, p2c in i); a key mask with ragged lengths."""
    h, d = 12, 64
    H = h * d
    qkv = torch.randn(B, S, 3 * H, generator=gen, device=dev).to(dtype)
    q, k, v = (qkv[..., i * H:(i + 1) * H].reshape(B, S, h, d).transpose(1, 2) for i in range(3))
    c2p = (4 * torch.randn(h, S, B, S, generator=gen, device=dev)).to(dtype).permute(2, 0, 1, 3)
    p2c = (4 * torch.randn(h, S, B, S, generator=gen, device=dev)).to(dtype).permute(2, 0, 3, 1)
    lengths = torch.full((B,), S, device=dev)
    if ragged:
        lengths = torch.randint(1, S + 1, (B,), generator=gen, device=dev)
        lengths[0] = S
    mask = (torch.arange(S, device=dev)[None, :] < lengths[:, None]).to(torch.int32)
    return q, k, v, c2p, p2c, mask


def check_bias_attention(gen: torch.Generator, dev) -> dict:
    from gliclass.c_tpu_torch.ops import fused_attention as FA

    h, d = 12, 64
    scale = math.sqrt(d * 3)
    # bf16: the fp32 score sums run in another order than the plain version's
    # matmul, and p is rounded to bf16 before p.v, so an element near a
    # rounding boundary can move one bf16 step (as for K1).
    tol = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, ops=0.0, nbytes=0.0)
    worst = 0.0
    # (B, S, dtype, ragged, timed): the two 512-bucket batches of the route
    # measurement, a ragged short bucket, and fp32.
    cases = ((128, 512, torch.bfloat16, True, True), (16, 512, torch.bfloat16, True, True),
             (16, 88, torch.bfloat16, True, False), (16, 88, torch.float32, True, False),
             (8, 512, torch.float32, True, False))
    for B, S, dtype, ragged, timed in cases:
        q, k, v, c2p, p2c, mask = bias_inputs(gen, dev, B, S, dtype, ragged)
        out = FA.bias_fused_attention(q, k, v, c2p, p2c, mask, scale)
        ref = FA.bias_fused_attention_plain(q, k, v, c2p, p2c, mask, scale)
        torch.cuda.synchronize()
        if not torch.isfinite(out.float()).all():
            fail(f"K7 B={B} S={S} {dtype}: non-finite output")
        err = (out.float() - ref.float()).abs().max().item()
        log(f"K7 bias_fused_attention B={B} h={h} S={S} d={d} {str(dtype)[6:]} "
            f"{'ragged keys' if ragged else 'full'}: max|kernel-plain|={err:.3e} (tol {tol[dtype]:.0e})")
        if err > tol[dtype]:
            fail(f"K7 B={B} S={S} {dtype}: max error {err} above {tol[dtype]}")
        del ref
        if not timed:
            continue
        worst = max(worst, err)
        ms = time_ms(lambda: FA.bias_fused_attention(q, k, v, c2p, p2c, mask, scale))
        plain = time_ms(lambda: FA.bias_fused_attention_plain(q, k, v, c2p, p2c, mask, scale), iters=5)
        # Yardstick only: one PyTorch call for the same function, the biases
        # summed (and masked) outside the timed call.
        bias = (c2p.float() + p2c.float()) * (1.0 / scale)
        bias = bias.masked_fill(mask[:, None, None, :] == 0, float("-inf")).to(dtype)
        lib = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=bias, scale=1.0 / scale))
        del bias
        # q.k and p.v over every (i, j) pair, 2 operations per multiply-add;
        # q, k, v read and out written once, both biases read once.
        ops = 4.0 * B * h * S * S * d
        nbytes = 4 * B * h * S * d * 2 + 2 * B * h * S * S * c2p.element_size() + B * S * 4
        bms, by = bound_ms(ops, "bf16", nbytes)
        log(f"   time: kernel {ms:.4f} ms | plain {plain:.4f} ms | scaled_dot_product_attention "
            f"{lib:.4f} ms | bound {bms:.4f} ms ({by}, {nbytes / 1e9:.3f} GB)")
        for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib), ("ops", ops),
                         ("nbytes", nbytes)):
            tot[key] += val
        torch.cuda.empty_cache()
    bms, by = bound_ms(tot["ops"], "bf16", tot["nbytes"])
    return dict(ms=tot["ms"], plain_ms=tot["plain_ms"], library_ms=tot["library_ms"], bound_ms=bms,
                bound_by=by, max_abs_err=worst, shape="sum of B=128 S=512, B=16 S=512 (h=12 d=64 bf16)")


# ---------------------------------------------------------------------------
# Phase 3/4: main path at full width
# ---------------------------------------------------------------------------
class WordTokenizer:
    """Word-level stand-in for a ``tokenizers.Tokenizer``: the methods that
    PromptTokenizer and AffixEncoder read. Special tokens split the text
    first (as in the real tokenizer), then whitespace; each word maps to a
    fixed id below the vocabulary size by CRC-32."""

    SPECIAL = {"[PAD]": 0, "[CLS]": 1, "[SEP]": 2, "<<LABEL>>": 3, "<<SEP>>": 4}
    padding = {"pad_id": 0}

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size
        self._split = re.compile(r"(<<LABEL>>|<<SEP>>)")

    def token_to_id(self, tok: str):
        return self.SPECIAL.get(tok)

    def _ids(self, text: str) -> list[int]:
        ids = []
        for part in self._split.split(text):
            if part in self.SPECIAL:
                ids.append(self.SPECIAL[part])
                continue
            for w in part.split():
                ids.append(16 + zlib.crc32(w.encode()) % (self.vocab_size - 16))
        return ids

    def encode(self, text: str, add_special_tokens: bool = True):
        ids = self._ids(text)
        if add_special_tokens:
            ids = [1] + ids + [2]
        return _Encoding(ids)

    def encode_batch(self, texts, add_special_tokens: bool = True):
        return [self.encode(t, add_special_tokens) for t in texts]


class _Encoding:
    def __init__(self, ids):
        self.ids = ids


def make_params(rng: np.random.Generator, bb, H_head: int) -> dict:
    """gliclass-base parameters at the published geometry, random (std 0.02
    weights, small biases), in the JAX package's layout."""
    H, I, L = bb.hidden_size, bb.intermediate_size, bb.num_hidden_layers

    def normal(*shape, std=0.02):
        return (rng.standard_normal(shape, dtype=np.float32) * std).astype(np.float32)

    def dense(d_in, d_out, lead=()):
        return {"w": normal(*lead, d_in, d_out), "b": normal(*lead, d_out, std=0.01)}

    def ln(d, lead=()):
        return {"scale": 1.0 + normal(*lead, d, std=0.05), "bias": normal(*lead, d, std=0.05)}

    span = bb.position_buckets
    backbone = {
        "embeddings": {"word": normal(bb.vocab_size, H, std=0.5), "ln": ln(H)},
        "rel_embeddings": normal(2 * span, H, std=0.5),
        "rel_ln": ln(H),
        "layers": {
            "attn": {n: dense(H, H, (L,)) for n in ("q", "k", "v", "o")} | {"ln": ln(H, (L,))},
            "ffn": {"up": dense(H, I, (L,)), "down": dense(I, H, (L,)), "ln": ln(H, (L,))},
        },
    }
    proj = lambda: {"linear_1": dense(H_head, 4 * H_head), "linear_2": dense(4 * H_head, H_head)}
    head = {"text_projector": proj(), "classes_projector": proj()}
    return {"backbone": backbone, "head": head}


def make_decoder_params(rng: np.random.Generator, bb, H_head: int) -> dict:
    """Llama/Qwen2 parameters at the given geometry, random, in the JAX
    package's layout, INT8-quantized one layer at a time (the fp32 tree of a
    1.5 B model would hold about 6 GB at once) and stacked on [L, ...].
    The head's second projection is small (std 0.004) so that the logits
    spread over a few units and the probabilities do not saturate."""
    from gliclass.c_tpu_torch.ops.quant import quantize_dense_param

    H, I, L = bb.hidden_size, bb.intermediate_size, bb.num_hidden_layers
    q_out, kv_out = bb.num_attention_heads * bb.head_dim, bb.kv_heads * bb.head_dim
    qkv_bias = bb.attention_bias or bb.model_type == "qwen2"

    def normal(*shape, std=0.02):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(std)

    def dense(d_in, d_out, bias=False, std=0.02):
        p = quantize_dense_param({"w": normal(d_in, d_out, std=std)})
        if bias:
            p["b"] = normal(d_out)
        return p

    def norm():
        return {"scale": 1.0 + normal(H, std=0.05)}

    layers = [
        {"attn": {"q": dense(H, q_out, qkv_bias), "k": dense(H, kv_out, qkv_bias),
                  "v": dense(H, kv_out, qkv_bias), "o": dense(q_out, H)},
         "attn_norm": norm(),
         "mlp": {"gate": dense(H, I), "up": dense(H, I), "down": dense(I, H)},
         "mlp_norm": norm()}
        for _ in range(L)
    ]
    stacked = _stack(layers)
    del layers
    backbone = {"embeddings": {"word": normal(bb.vocab_size, H)}, "layers": stacked,
                "final_norm": norm()}
    proj = lambda: {"linear_1": dense(H_head, 4 * H_head, True),
                    "linear_2": dense(4 * H_head, H_head, True, std=0.004)}
    return {"backbone": backbone, "head": {"text_projector": proj(), "classes_projector": proj()}}


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack(trees)


def make_job(rng: np.random.Generator, n_short: int, n_long: int) -> dict:
    words = [f"w{i}" for i in range(5000)] + ["market", "team", "vote", "virus", "film"]
    labels = ["politics", "sports", "business", "science", "health",
              "entertainment", "technology", "travel"]
    texts = [" ".join(rng.choice(words, size=int(rng.integers(20, 61)))) for _ in range(n_short)]
    texts += [" ".join(rng.choice(words, size=int(rng.integers(420, 460)))) for _ in range(n_long)]
    return {"texts": texts, "labels": [labels], "same_labels": True,
            "classification_type": "multi-label"}


def counters() -> dict:
    """Kernel name -> (module of its wrapper, name of its launch counter)."""
    from gliclass.c_tpu_torch.ops import causal_attention, fused_attention, fused_ffn, int8_matmul

    return {"flash_disentangled_attention": (fused_attention, "launches"),
            "fused_ffn_w8a8": (fused_ffn, "launches"),
            "int8_matmul": (int8_matmul, "launches"),
            "fused_ffn_wonly": (fused_ffn, "launches_wonly"),
            "causal_flash_attention": (causal_attention, "launches"),
            "abs_pos_table": (fused_attention, "launches_table"),
            "bias_fused_attention": (fused_attention, "launches_bias")}


def reset_counts() -> None:
    for mod, attr in counters().values():
        setattr(mod, attr, 0)


def read_counts() -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in counters().items()}


def profile_job(pipe, job, wall_s: float) -> None:
    """Device time by kernel over one more classify_job pass (torch.profiler),
    and the device's busy share: the kernels' summed time (one stream, so
    they do not overlap) over ``wall_s``, the median wall time of the same
    pass without the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        pipe.classify_job(job)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Device-side events only: an operator's row repeats its kernels' time.
    rows = sorted(
        ((evt.self_device_time_total / 1e3, evt.count, evt.key) for evt in prof.key_averages()
         if evt.device_type == DeviceType.CUDA and evt.self_device_time_total > 0),
        reverse=True,
    )
    if not rows:
        log("   profile: the profiler recorded no device time (not measured)")
        return
    busy = sum(r[0] for r in rows)
    log(f"   profile: device busy {busy:.2f} ms = {100 * busy / (wall_s * 1e3):.1f}% of the "
        f"{wall_s * 1e3:.2f} ms pass (profiled pass {wall_ms:.2f} ms), by kernel:")
    for ms, n, key in rows[:12]:
        log(f"      {ms:9.3f} ms  {100 * ms / busy:5.1f}%  x{n:<5d} {key[:90]}")


def hidden_states(engine, batch) -> torch.Tensor:
    """The backbone's output [B, S, H] (fp32, on the host) for a tokenized
    batch, in the engine's precision mode and attention route."""
    from gliclass.c_tpu_torch.models.gliclass import encode_backbone
    from gliclass.c_tpu_torch.ops.layers import act_quant

    ids, mask = engine._device_inputs(batch.input_ids, batch.attention_mask)
    with torch.inference_mode(), act_quant(engine._act_quant):
        h = encode_backbone(engine.params["backbone"], ids, mask, engine.cfg, engine.compute_dtype,
                            engine.runtime.attn_route)
    return h.float().cpu()


def run_path(cfg, qparams, tok, job_dict, quant_mode: str, dev, n_cpu: int, label: str,
             batch_size: int = 128, hidden_tol: float = 0.1, prob_tol: float = 0.15,
             profile: bool = False) -> tuple[dict, int]:
    """classify_job on the card: a warm pass, then three timed passes; the
    launch counts and the number of forwards of the first timed pass; the
    first ``n_cpu`` texts against the same port on the CPU.

    The CPU comparison holds the backbone's hidden states (relative L2 error
    over valid tokens) in this precision mode (``hidden_tol``) and in fp32
    with the same INT8 weights (weight-only, tolerance 1e-4), and the
    probabilities (``prob_tol``). In bf16 with INT8 weights the two devices
    round in another order, and each w8a8 re-quantization turns a last-bit
    difference into a whole int8 step on the elements near a rounding
    boundary. Measured with every kernel replaced by its plain version on the
    card: the hidden states drift 2.6% after gliclass-base's 12 layers
    (int8-dynamic; 1.1% in int8) and 9.0% after qwen-1.5B's 28, the
    probabilities up to 0.13 apart (the random head's text and label vectors
    are nearly orthogonal, so their dot product magnifies the drift); in
    fp32 the drift is 1.4e-6 and 8.1e-6. A fault in a kernel's layout or
    indexing gives an O(1) hidden error."""
    from gliclass.c_tpu_torch.config import RuntimeConfig
    from gliclass.c_tpu_torch.data import parse_job
    from gliclass.c_tpu_torch.engine import InferenceEngine
    from gliclass.c_tpu_torch.pipeline import ZeroShotClassificationPipeline

    rt = RuntimeConfig(batch_size=batch_size, max_length=512, compute_dtype="bfloat16",
                       quant_mode=quant_mode, seq_buckets=SEQ_LADDER, label_buckets=(8,))
    job = parse_job(job_dict)
    engine = InferenceEngine(cfg, qparams, rt, device=dev)
    forwards = count_forwards(engine)
    pipe = ZeroShotClassificationPipeline(engine, tok, rt)
    t0 = time.perf_counter()
    pipe.classify_job(job)  # first pass: library handles, allocator growth
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    forwards.clear()
    t0 = time.perf_counter()
    out = pipe.classify_job(job)
    torch.cuda.synchronize()
    walls = [time.perf_counter() - t0]
    counts, n_fwd = read_counts(), len(forwards)
    for _ in range(2):  # spread of the same pass
        t0 = time.perf_counter()
        pipe.classify_job(job)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = statistics.median(walls)
    if out.failures:
        fail(f"{label}: batch failures {[f.to_dict() for f in out.failures]}")
    if out.probs.shape != (len(job_dict["texts"]), 8) or not np.isfinite(out.probs).all():
        fail(f"{label}: probabilities of shape {out.probs.shape}, finite={np.isfinite(out.probs).all()}")
    n = len(job_dict["texts"])
    log(f"{label}: {n} texts, median of 3 passes {wall:.4f} s = {n / wall:.1f} texts/s "
        f"(passes {', '.join(f'{w:.4f}' for w in walls)} s; first pass {cold:.3f} s)")
    log(f"   stages: {json.dumps(out.timings)}")
    log(f"   forwards: {n_fwd}; launches: {json.dumps(counts)}")
    log(f"   peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if profile:
        profile_job(pipe, job, wall)

    # The same port on the CPU (plain versions) for the first n_cpu texts.
    from gliclass.c_tpu_torch.prompting import pack_prompts

    sub = dict(job_dict, texts=job_dict["texts"][:n_cpu])
    t0 = time.perf_counter()
    cpu_engine = InferenceEngine(cfg, qparams, rt, device="cpu")
    cpu = ZeroShotClassificationPipeline(cpu_engine, tok, rt).classify_job(parse_job(sub))
    batch = tok.encode_batch(pack_prompts(sub["texts"], sub["labels"], True, cfg.prompt_first),
                             max_length=rt.max_length)
    h_card, h_cpu = hidden_states(engine, batch), hidden_states(cpu_engine, batch)
    valid = torch.from_numpy(batch.attention_mask).bool()
    rel = lambda a, b: ((a[valid] - b[valid]).norm() / b[valid].norm()).item()
    herr = rel(h_card, h_cpu)
    rt32 = dataclasses.replace(rt, compute_dtype="float32", quant_mode="int8")
    herr32 = rel(hidden_states(InferenceEngine(cfg, engine.params, rt32, device=dev), batch),
                 hidden_states(InferenceEngine(cfg, cpu_engine.params, rt32, device="cpu"), batch))
    diff = float(np.abs(cpu.probs - out.probs[:n_cpu]).max())
    labels = lambda res: [[d["label"] for d in r["decisions"]] for r in res.to_json()]
    same = labels(cpu) == labels(out)[:n_cpu]
    log(f"   card vs CPU, first {n_cpu} texts: hidden states rel err {herr:.3e} (tol {hidden_tol:g}), "
        f"in fp32 {herr32:.3e} (tol 1e-4); "
        f"max|dprob| {diff:.3e} (tol {prob_tol:g}); decisions {'equal' if same else 'differ'}; "
        f"probabilities in [{out.probs[:n_cpu].min():.3f}, {out.probs[:n_cpu].max():.3f}]; "
        f"CPU runs {time.perf_counter() - t0:.1f} s")
    if not herr <= hidden_tol:
        fail(f"{label}: card and CPU hidden states differ by {herr} (relative)")
    if not herr32 <= 1e-4:
        fail(f"{label}: card and CPU fp32 hidden states differ by {herr32} (relative)")
    if diff > prob_tol:
        fail(f"{label}: card and CPU probabilities disagree by {diff}")
    return counts, n_fwd


@contextlib.contextmanager
def phase(name: str):
    """Print a phase's wall time when it ends."""
    log(f"=== {name}")
    t0 = time.perf_counter()
    yield
    log(f"=== {name}: {time.perf_counter() - t0:.1f} s")


def expect_launches(counts: dict, name: str, want: int, label: str) -> None:
    """A kernel of the path must have run, once per layer and forward."""
    if want <= 0 or counts[name] != want:
        fail(f"{label}: {name} launched {counts[name]} times, expected {want}")


def expect_none(counts: dict, name: str, label: str) -> None:
    if counts[name] != 0:
        fail(f"{label}: {name} launched {counts[name]} times, expected none")


def count_forwards(engine) -> list:
    """Wrap ``engine._forward`` to record the (rows, seq) of every forward."""
    shapes = []
    step = engine._forward

    def counted(ids, mask, max_labels):
        shapes.append(tuple(ids.shape))
        return step(ids, mask, max_labels)

    engine._forward = counted
    return shapes


def route_measurement(cfg, qparams, tok, rng: np.random.Generator, dev) -> dict:
    """The flash route (K1) against the bias route (K6 + bias products + K7)
    on gliclass-base int8-dynamic at full width: the whole forward at
    [128, 512] and [16, 512] (CUDA events, turns alternated), classify_job
    on 128 texts of the 512 bucket at batch 128 (texts/s, launches, peak
    memory), fp32 hidden states of two texts route against route, and a
    profile of the bias run."""
    from gliclass.c_tpu_torch.config import RuntimeConfig
    from gliclass.c_tpu_torch.data import parse_job
    from gliclass.c_tpu_torch.engine import InferenceEngine
    from gliclass.c_tpu_torch.pipeline import ZeroShotClassificationPipeline
    from gliclass.c_tpu_torch.prompting import pack_prompts

    L = cfg.backbone.num_hidden_layers
    job_dict = make_job(rng, 0, 128)
    rt = RuntimeConfig(batch_size=128, max_length=512, compute_dtype="bfloat16", quant_mode="int8-dynamic",
                       seq_buckets=SEQ_LADDER, label_buckets=(8,))
    engines = {"flash": InferenceEngine(cfg, qparams, dataclasses.replace(rt, attn_route="flash"), device=dev)}
    engines["bias"] = InferenceEngine(cfg, engines["flash"].params, dataclasses.replace(rt, attn_route="bias"),
                                      device=dev)
    batch = tok.encode_batch(pack_prompts(job_dict["texts"], job_dict["labels"], True, cfg.prompt_first),
                             max_length=512, pad_to=512)
    if batch.seq_length != 512 or int(batch.lengths.min()) <= 384:
        fail(f"route phase: the long texts do not all fall in the 512 bucket ({batch.lengths.min()})")
    ids, mask = engines["flash"]._device_inputs(batch.input_ids, batch.attention_mask)

    fwd = {}
    for B in (128, 64, 32, 16):
        times = {"flash": [], "bias": []}
        for order in (("flash", "bias"), ("bias", "flash")):
            for r in order:
                times[r].append(time_ms(lambda: engines[r]._forward(ids[:B], mask[:B], 8), iters=3, warmup=1))
        for r in ("flash", "bias"):
            fwd[(r, B)] = statistics.median(times[r])
        log(f"forward [{B}, 512] gliclass-base int8-dynamic: flash {fwd[('flash', B)]:.3f} ms "
            f"(turns {', '.join(f'{t:.3f}' for t in times['flash'])}), bias {fwd[('bias', B)]:.3f} ms "
            f"(turns {', '.join(f'{t:.3f}' for t in times['bias'])})")

    job = parse_job(job_dict)
    rate, counts = {}, {}
    for r in ("flash", "bias", "bias", "flash"):
        pipe = ZeroShotClassificationPipeline(engines[r], tok, engines[r].runtime)
        shapes = count_forwards(engines[r])
        pipe.classify_job(job)  # warm: allocator growth at this shape
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        shapes.clear()
        t0 = time.perf_counter()
        out = pipe.classify_job(job)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        del engines[r]._forward  # back to the class's forward
        if out.failures or not np.isfinite(out.probs).all():
            fail(f"route phase {r}: failures {out.failures} or non-finite probabilities")
        rate.setdefault(r, []).append(128 / wall)
        if r in counts:
            continue
        counts[r] = read_counts()
        n_fwd = len(shapes)
        log(f"{r} route: 128 texts of the 512 bucket in {wall:.4f} s = {128 / wall:.1f} texts/s; "
            f"forwards {shapes}; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
            f"launches {json.dumps(counts[r])}")
        if r == "bias":
            expect_launches(counts[r], "abs_pos_table", 2 * L * n_fwd, "bias route")
            expect_launches(counts[r], "bias_fused_attention", L * n_fwd, "bias route")
            expect_none(counts[r], "flash_disentangled_attention", "bias route")
        else:
            expect_launches(counts[r], "flash_disentangled_attention", L * n_fwd, "flash route")
            expect_none(counts[r], "bias_fused_attention", "flash route")
    for r in ("flash", "bias"):
        log(f"{r} route texts/s, turns flash-bias-bias-flash: {', '.join(f'{x:.1f}' for x in rate[r])}")
    profile_job(ZeroShotClassificationPipeline(engines["bias"], tok, engines["bias"].runtime), job,
                128 / statistics.mean(rate["bias"]))

    # fp32 (INT8 weight-only) hidden states of two texts, route against route.
    two = tok.encode_batch(pack_prompts(job_dict["texts"][:2], job_dict["labels"], True, cfg.prompt_first),
                           max_length=512, pad_to=512)
    rt32 = dataclasses.replace(rt, compute_dtype="float32", quant_mode="int8")
    hs = {r: hidden_states(InferenceEngine(cfg, engines["flash"].params, dataclasses.replace(rt32, attn_route=r),
                                           device=dev), two) for r in ("flash", "bias")}
    valid = torch.from_numpy(two.attention_mask).bool()
    herr = ((hs["bias"][valid] - hs["flash"][valid]).norm() / hs["flash"][valid].norm()).item()
    log(f"fp32 hidden states, bias route vs flash route on the card, 2 texts: rel L2 {herr:.3e} (tol 1e-4)")
    if not herr <= 1e-4:
        fail(f"route phase: bias and flash hidden states differ by {herr} (relative)")
    from gliclass.c_tpu_torch.ops.fused_attention import attention_route

    log("auto route at S=512: " + ", ".join(f"B={B} {attention_route(512, B, 64)}" for B in (16, 32, 64, 128)))
    log("route decision input, forward ms bias vs flash at S=512: " + "; ".join(
        f"B={B} {fwd[('bias', B)]:.3f} vs {fwd[('flash', B)]:.3f} "
        f"({'bias' if fwd[('bias', B)] < fwd[('flash', B)] else 'flash'} faster)" for B in (16, 32, 64, 128)))
    return dict(forward_ms={f"{r} {B}": v for (r, B), v in fwd.items()}, texts_per_s=rate, hidden_rel=herr)


def serve_path(cfg, qparams, tok, rng: np.random.Generator, dev) -> tuple[dict, int]:
    """GLiClassServer on 127.0.0.1 over the bias route: 16 client threads
    post 256 requests over HTTP (64 carrying 2-4 texts of the 512 bucket,
    each thread's first four, so that the 512 bucket sees batches above 16;
    the rest 1-4 short texts), all with the 8 shared labels and threshold 0.
    Each request must be answered once, with its own texts; the scores must
    agree with classify_job on the same engine (bf16 bound 0.15); K6 and K7
    must launch 24 and 12 times per forward, K1 never. A second pass of the
    same traffic runs under the profiler for the device's busy share."""
    import threading
    import urllib.request

    from gliclass.c_tpu_torch.config import RuntimeConfig
    from gliclass.c_tpu_torch.data import parse_job
    from gliclass.c_tpu_torch.engine import InferenceEngine
    from gliclass.c_tpu_torch.pipeline import ZeroShotClassificationPipeline
    from gliclass.c_tpu_torch.serving import GLiClassServer

    L = cfg.backbone.num_hidden_layers
    rt = RuntimeConfig(batch_size=64, max_length=512, compute_dtype="bfloat16", quant_mode="int8-dynamic",
                       seq_buckets=SEQ_LADDER, label_buckets=(8,), attn_route="bias")
    engine = InferenceEngine(cfg, qparams, rt, device=dev)
    t0 = time.perf_counter()
    n_warm = engine.warmup(max_seq=512)
    log(f"warmup: {n_warm} steps (every seq and row bucket, bias route) in {time.perf_counter() - t0:.1f} s")
    labels = make_job(rng, 0, 0)["labels"][0]
    n_threads, per_thread = 16, 16
    bodies = []  # bodies[t][m]
    for t in range(n_threads):
        reqs = []
        for m in range(per_thread):
            long = m < 4
            n = int(rng.integers(2, 5)) if long else int(rng.integers(1, 5))
            texts = make_job(rng, 0 if long else n, n if long else 0)["texts"]
            reqs.append({"texts": texts, "labels": labels, "threshold": 0.0})
        bodies.append(reqs)

    shapes = count_forwards(engine)
    # A 50 ms fill window: with 16 closed-loop clients and the default 5 ms a
    # round holds only what arrives in 5 ms, and the 512 bucket never sees
    # more than 16 rows.
    server = GLiClassServer(engine, tok, rt, host="127.0.0.1", port=0, max_wait_ms=50.0)
    server.start()

    def drive() -> tuple[dict, float]:
        answers, errors = {}, []
        lock = threading.Lock()
        barrier = threading.Barrier(n_threads)

        def client(t):
            try:
                barrier.wait(timeout=60)
                for m, body in enumerate(bodies[t]):
                    req = urllib.request.Request(f"http://127.0.0.1:{server.port}/classify",
                                                 data=json.dumps(body).encode(),
                                                 headers={"Content-Type": "application/json"})
                    with urllib.request.urlopen(req, timeout=300) as resp:
                        got = json.loads(resp.read())
                    with lock:
                        if (t, m) in answers:
                            errors.append(f"request {t}/{m} answered twice")
                        answers[(t, m)] = got
            except Exception as e:  # reported below, and the phase fails
                with lock:
                    errors.append(f"client {t}: {type(e).__name__}: {e}")

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(t,)) for t in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t0
        if any(th.is_alive() for th in threads) or errors:
            server.close()
            fail(f"serve path: {errors[:5]} (threads alive: {sum(th.is_alive() for th in threads)})")
        return answers, wall

    reset_counts()
    shapes.clear()
    answers, wall = drive()
    counts, n_fwd = read_counts(), len(shapes)
    with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/metrics", timeout=30) as resp:
        metrics = json.loads(resp.read())
    # The same traffic again under the profiler (device activity only), for
    # the device's busy share; latencies and counts come from the pass above.
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, wall_prof = drive()
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e6
    server.close()
    n_req = n_threads * per_thread
    if len(answers) != n_req:
        fail(f"serve path: {len(answers)} of {n_req} requests answered")
    n_texts = sum(len(b["texts"]) for reqs in bodies for b in reqs)
    long_rows = max((b for b, s in shapes if s == 512), default=0)
    lat = metrics["latency"]
    log(f"serve: {n_req} requests ({n_texts} texts) from {n_threads} threads in {wall:.3f} s = "
        f"{n_req / wall:.1f} requests/s, {n_texts / wall:.1f} texts/s; latency p50 {lat['p50_ms']} ms, "
        f"p95 {lat['p95_ms']} ms, p99 {lat['p99_ms']} ms (/metrics: {json.dumps(metrics)})")
    log(f"   forwards {n_fwd} (rows x seq: {sorted(set(shapes))}); largest 512-bucket batch {long_rows} rows; "
        f"launches {json.dumps(counts)}")
    log(f"   profiled pass of the same traffic: {wall_prof:.3f} s, device busy {busy:.3f} s "
        f"= {100 * busy / wall_prof:.1f}%" if busy else "   profile: no device time recorded (not measured)")
    if metrics["requests"] != n_req or metrics["errors"] != 0:
        fail(f"serve path: /metrics counts {metrics['requests']} requests, {metrics['errors']} errors")
    if long_rows <= 16:
        fail(f"serve path: the 512 bucket saw at most {long_rows} rows, not above 16")
    expect_launches(counts, "abs_pos_table", 2 * L * n_fwd, "serve path")
    expect_launches(counts, "bias_fused_attention", L * n_fwd, "serve path")
    expect_none(counts, "flash_disentangled_attention", "serve path")

    # Each answer carries its own texts; its scores agree with classify_job.
    texts = [tx for reqs in bodies for b in reqs for tx in b["texts"]]
    ref = ZeroShotClassificationPipeline(engine, tok, rt).classify_job(parse_job(
        {"texts": texts, "labels": [labels], "same_labels": True, "classification_type": "multi-label"}))
    worst, i = 0.0, 0
    for t in range(n_threads):
        for m, body in enumerate(bodies[t]):
            res = answers[(t, m)]["results"]
            if [r["text"] for r in res] != body["texts"]:
                fail(f"serve path: request {t}/{m} answered with other texts")
            for r in res:
                scores = {d["label"]: d["score"] for d in r["decisions"]}
                if sorted(scores) != sorted(labels):
                    fail(f"serve path: request {t}/{m} has decisions for {sorted(scores)}")
                worst = max(worst, max(abs(scores[l] - float(ref.probs[i, k])) for k, l in enumerate(labels)))
                i += 1
    log(f"   scores vs classify_job on the same engine and texts: max |dprob| {worst:.3e} (tol 0.15)")
    if worst > 0.15:
        fail(f"serve path: scores differ from classify_job by {worst}")
    return counts, n_fwd


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device; this smoke run needs the card", flush=True)
        return 2
    from gliclass.c_tpu_torch.config import GLiClassConfig, deberta_v3_config, llama_config, qwen2_config
    from gliclass.c_tpu_torch.ops import _build
    from gliclass.c_tpu_torch.ops.quant import quantize_tree
    from gliclass.c_tpu_torch.tokenization import PromptTokenizer

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = smi_line()
    log(f"device: {kind} | nvidia-smi: {card} | torch {torch.__version__} cuda {torch.version.cuda}")
    with phase("phase 1: kernel build"):
        _build.lib(verbose=True)

    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    rng = np.random.default_rng(args.seed)
    with phase("phase 2: kernels against their plain versions"):
        rec = {
            "flash_disentangled_attention": check_attention(gen, dev),
            "fused_ffn_w8a8": check_ffn(gen, dev, rng),
            "int8_matmul": check_int8_matmul(gen, dev, rng),
            # Generators of their own from here on, so that the gliclass-base
            # phases draw the same weights and job as before K4 and K5 came.
            "fused_ffn_wonly": check_ffn_wonly(gen, dev, np.random.default_rng([args.seed, 4])),
            "causal_flash_attention": check_causal(gen, dev),
            # Generators of their own again, for the same reason.
            "abs_pos_table": check_abs_pos_table(torch.Generator(device=dev).manual_seed(args.seed + 6), dev),
            "bias_fused_attention": check_bias_attention(torch.Generator(device=dev).manual_seed(args.seed + 7),
                                                         dev),
        }

    # Each kernel's launches come from the run of the path it serves.
    launches, paths = {}, {}
    with phase("phase 3: gliclass-base int8-dynamic"):
        bb = deberta_v3_config("base")
        tok = PromptTokenizer(WordTokenizer(bb.vocab_size))
        cfg = GLiClassConfig(hidden_size=bb.hidden_size, class_token_index=tok.label_token_id,
                             text_token_index=tok.sep_token_id, prompt_first=True, backbone=bb)
        t0 = time.perf_counter()
        qparams = quantize_tree(make_params(rng, bb, cfg.hidden_size))
        n_params = sum(a.size for a in _leaves(qparams))
        log(f"gliclass-base params: {n_params / 1e6:.1f} M (INT8 layers), made and quantized in "
            f"{time.perf_counter() - t0:.1f} s")
        job = make_job(rng, 384, 16)
        counts, n_fwd = run_path(cfg, qparams, tok, job, "int8-dynamic", dev, 8,
                                 "main path int8-dynamic", profile=True)
        for name in ("flash_disentangled_attention", "fused_ffn_w8a8"):
            expect_launches(counts, name, bb.num_hidden_layers * n_fwd, "main path")
            launches[name], paths[name] = counts[name], "gliclass-base int8-dynamic"

    with phase("phase 4: gliclass-base weight-only int8"):
        sub = dict(job, texts=job["texts"][:128] + job["texts"][-4:])
        counts, n_fwd = run_path(cfg, qparams, tok, sub, "int8", dev, 4, "weight-only int8")
        expect_launches(counts, "fused_ffn_wonly", bb.num_hidden_layers * n_fwd, "weight-only path")
        if counts["int8_matmul"] <= 0:
            fail("weight-only path did not launch int8_matmul")
        for name in ("int8_matmul", "fused_ffn_wonly"):
            launches[name], paths[name] = counts[name], "gliclass-base int8"

    with phase("phase 5: flash route against bias route, gliclass-base int8-dynamic at [128, 512]"):
        route_measurement(cfg, qparams, tok, np.random.default_rng([args.seed, 7]), dev)
        torch.cuda.empty_cache()

    with phase("phase 6: serve path, GLiClassServer over the bias route"):
        counts, n_fwd = serve_path(cfg, qparams, tok, np.random.default_rng([args.seed, 8]), dev)
        for name in ("abs_pos_table", "bias_fused_attention"):
            launches[name], paths[name] = counts[name], "serve: gliclass-base int8-dynamic, attn_route=bias"
    del qparams
    torch.cuda.empty_cache()

    with phase("phase 7: gliclass-qwen-1.5B int8-dynamic"):
        bb = qwen2_config("1.5b")
        tok = PromptTokenizer(WordTokenizer(bb.vocab_size))
        cfg = GLiClassConfig(hidden_size=bb.hidden_size, class_token_index=tok.label_token_id,
                             text_token_index=tok.sep_token_id, prompt_first=False, backbone=bb)
        t0 = time.perf_counter()
        rng = np.random.default_rng([args.seed, 5])
        qparams = make_decoder_params(rng, bb, cfg.hidden_size)
        n_params = sum(a.size for a in _leaves(qparams))
        log(f"gliclass-qwen-1.5B params: {n_params / 1e6:.1f} M ({bb.num_hidden_layers} layers, "
            f"H={bb.hidden_size}, INT8 layers), made and quantized layer by layer in "
            f"{time.perf_counter() - t0:.1f} s")
        job = make_job(rng, 384, 16)
        # 28 layers: the 0.2% per layer drift of run_path's note gives about
        # 6%; the bound leaves room for the longer (512-bucket) rows.
        counts, n_fwd = run_path(cfg, qparams, tok, job, "int8-dynamic", dev, 4,
                                 "qwen-1.5B int8-dynamic", batch_size=64, hidden_tol=0.15, profile=True)
        expect_launches(counts, "causal_flash_attention", bb.num_hidden_layers * n_fwd, "qwen path")
        launches["causal_flash_attention"] = counts["causal_flash_attention"]
        paths["causal_flash_attention"] = "gliclass-qwen-1.5B int8-dynamic"
        del qparams
        torch.cuda.empty_cache()

    with phase("phase 8: llama-1.3B geometry, 4 of 24 layers, int8-dynamic"):
        bb = dataclasses.replace(llama_config("1.3b"), num_hidden_layers=4)
        tok = PromptTokenizer(WordTokenizer(bb.vocab_size))
        cfg = GLiClassConfig(hidden_size=bb.hidden_size, class_token_index=tok.label_token_id,
                             text_token_index=tok.sep_token_id, prompt_first=False, backbone=bb)
        rng = np.random.default_rng([args.seed, 6])
        qparams = make_decoder_params(rng, bb, cfg.hidden_size)
        job = make_job(rng, 64, 16)
        counts, n_fwd = run_path(cfg, qparams, tok, job, "int8-dynamic", dev, 4,
                                 "llama-1.3B (4 of 24 layers) int8-dynamic", batch_size=64)
        expect_launches(counts, "causal_flash_attention", bb.num_hidden_layers * n_fwd, "llama path")
        del qparams

    sources = {
        "flash_disentangled_attention": ("gliclass/c_tpu_torch/csrc/flash_disentangled_attention.cu",
                                         "gliclass/c_tpu/ops/fused_attention.py:275"),
        "fused_ffn_w8a8": ("gliclass/c_tpu_torch/csrc/fused_ffn_w8a8.cu", "gliclass/c_tpu/ops/fused_ffn.py:78"),
        "int8_matmul": ("gliclass/c_tpu_torch/csrc/int8_matmul.cu", "gliclass/c_tpu/ops/int8_matmul.py:35"),
        "fused_ffn_wonly": ("gliclass/c_tpu_torch/csrc/fused_ffn_wonly.cu", "gliclass/c_tpu/ops/fused_ffn.py:91"),
        "causal_flash_attention": ("gliclass/c_tpu_torch/csrc/causal_flash_attention.cu",
                                   "gliclass/c_tpu/ops/causal_attention.py:116"),
        "abs_pos_table": ("gliclass/c_tpu_torch/csrc/abs_pos_table.cu", "gliclass/c_tpu/ops/fused_attention.py:470"),
        "bias_fused_attention": ("gliclass/c_tpu_torch/csrc/bias_fused_attention.cu",
                                 "gliclass/c_tpu/ops/fused_attention.py:547"),
    }
    kernels = []
    for name, r in rec.items():
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name][0], "replaces": sources[name][1],
            "launches": launches[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r.get("library_ms"), "shape": r["shape"], "path": paths[name],
        })
    log(f"total wall time: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                            "count": torch.cuda.device_count()}}), flush=True)
    return 0


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


if __name__ == "__main__":
    sys.exit(main())
