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
   precomputed biases, K8 whole-row disentangled attention, K9 the tiled
   route's windowed position tables (exact), K10 its flash attention over
   them. K1, K2, K3, K4, K5, K7, K8 and K10 run their bf16 (K2: int8)
   tensor-core variants on bf16 inputs (K2 and K4 at H and I multiples of
   16, K3 at K a multiple of 8 and N of 16, K5 at d a multiple of 16;
   asserted by their counters) and their CUDA-core variants on fp32, mixed
   types and the other shapes; the CUDA-core variants are timed on the bf16
   inputs too, and K2's tensor-core variant must equal its CUDA-core one bit
   for bit. Every kernel's time is taken through its wrapper; K2, K4, K5, K6
   and K9 also give their (tensor-core) C entry's time with the arguments
   built once and the profiler's device time (K5 SDPA's too); K1 is also
   timed alone at the four shapes the main path sends it, K6 at S = 56, 72,
   88, 128 and 512 (held exact at each, fp32 and bf16). K6 and K9 are also
   held exact on a table that starts one element past a 16-byte boundary.
3. DeBERTa main path, full width: gliclass-base (DeBERTa-v3-base, 12 layers,
   H=768, vocab 128,100) with random weights made from --seed,
   INT8-quantized, run through ZeroShotClassificationPipeline.classify_job
   in bf16 "int8-dynamic"; texts/s (median of 3 passes), stage timings,
   launch counts of K2 and of the attention kernels of the route "auto"
   takes at each forward's (rows, seq) (reset just before the pass, read
   just after; every K2 and K1 launch on tensor cores), a torch.profiler
   breakdown of device time by kernel, peak device memory, and agreement of
   the first 8 texts with the same port on the CPU.
4. Weight-only path: the same model and a subset of the job in "int8"; the
   launch counts of K4 (12 per forward) and K3 (every launch of both on
   tensor cores), a torch.profiler breakdown of device time by kernel,
   agreement with the CPU.
5. The two DeBERTa attention routes on the same model, "int8-dynamic":
   the whole forward at [128, 512] and [16, 512] with the route forced to
   flash (K1) and to bias (K6 + bias products + K7), classify_job texts/s on
   128 texts of the 512 bucket at batch 128, launches (K6 24 and K7 12 per
   forward, K1 none on the bias run), peak memory, a profile of the bias
   run, and fp32 hidden states bias against flash (1e-4).
6. The four attention routes on the same model, "int8-dynamic": the whole
   forward at [B, 512] for B = 128, 64, 32, 16, 8, [B, 128] for B = 128, 32 and
   the main job's [128, 56], [128, 88], [128, 72], [64, 56] and [32, 72]
   with the route forced to
   flash, bias, row (K8) and tiled (K9 + K10), two turns in opposite
   orders; classify_job on phase 3's job under row and under tiled (texts/s,
   forwards, peak memory, a profile, agreement with the CPU) with exact
   launch counts per forward (row: K8 12 on tensor cores, K1 none; tiled:
   K9 24 and K10 12 on tensor cores in the buckets that are multiples of
   32, K1 12 in the others); one
   forward of the 512 bucket launching K10 12 times; fp32 hidden states of
   row and tiled against flash at S=512 and 128 (1e-4).
7. Serve path: GLiClassServer on 127.0.0.1 (the same model, attn_route
   "bias", warmed up), 16 client threads posting 256 requests over HTTP;
   each answered once, scores against classify_job, K6/K7 launches per
   forward (K7 on tensor cores), /metrics latency percentiles and
   requests/s, the device's busy share and top kernels under the profiler.
8. Decoder main path, full width and depth: gliclass-qwen-1.5B (Qwen2-1.5B,
   28 layers, H=1536, 12 query / 2 kv heads, d=128, I=8960, vocab 151,936),
   random INT8 weights made layer by layer, "int8-dynamic" through
   classify_job; texts/s, stages, profile, peak memory; K5 launched 28 times
   per forward, all on tensor cores; the first 4 texts against the CPU.
9. Llama-1.3B geometry at full width and 4 of its 24 layers (g=1, no q/k/v
   bias, vocab 32,000), "int8-dynamic", a small job; K5 launches (all on
   tensor cores) and agreement with the CPU.
10. One JSON line of kernel records (all ten kernels), the card line, and
    the final status line.

Needs torch, numpy and the CUDA toolkit (nvcc); no JAX, no network.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
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


def device_ms_by_kernel(fn, iters: int = 20) -> dict:
    """Device time per call of each kernel that ``fn`` launches, by name
    (torch.profiler over ``iters`` calls, after one warm call); empty where
    the profiler recorded no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0:
            name = e.key.split("(anonymous namespace)::")[-1][:60]  # K4′'s two launches differ in the template
            out[name] = out.get(name, 0.0) + e.self_device_time_total / 1e3 / iters
    return out


def device_ms(fn) -> float | None:
    """Summed device time per call of the kernels ``fn`` launches; None
    (not measured) where the profiler recorded none."""
    by_kernel = device_ms_by_kernel(fn)
    return sum(by_kernel.values()) if by_kernel else None


def fmt_ms(ms: float | None) -> str:
    return "not measured" if ms is None else f"{ms:.4f} ms"


def bound_ms(ops: float, op_type: str, nbytes: float) -> tuple[float, str]:
    t_ops = ops / PEAK_OPS[op_type] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------
# K1's (rows, bucket) shapes in phase 2: the three whose times are summed
# (in fp32 and bf16), then the other forwards of the main path in bf16.
# Phase 3 fails if "auto" sends K1 a shape outside both.
K1_SUMMED_SHAPES = ((128, 56), (128, 128), (16, 512))
K1_MAIN_SHAPES = ((128, 56), (128, 72), (64, 56), (32, 72), (128, 88))


def check_attention(gen: torch.Generator, dev, seed: int) -> dict:
    from gliclass.c_tpu_torch.ops import fused_attention as FA

    h, d = 12, 64
    H = h * d
    scale = math.sqrt(d * 3)
    # bf16 runs the tensor-core variant (fp32 sums in another order, exp by
    # ex2.approx at the running max, one reciprocal per row), fp32 the
    # CUDA-core one.
    tol = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
    worst = 0.0
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, cuda_core_ms=0.0, ops=0.0, nbytes=0.0)

    def inputs(g, B, S, dtype):
        # q/k/v as head-split views of one fused [B, S, 3H] projection, the
        # layout the model passes.
        qkv = torch.randn(B, S, 3 * H, generator=g, device=dev).to(dtype)
        q, k, v = (qkv[..., i * H:(i + 1) * H].reshape(B, S, h, d).transpose(1, 2) for i in range(3))
        pos_k = torch.randn(h, 2 * S - 1, d, generator=g, device=dev).to(dtype)
        pos_q = torch.randn(h, 2 * S - 1, d, generator=g, device=dev).to(dtype)
        lengths = torch.randint(1, S + 1, (B,), generator=g, device=dev)
        lengths[0] = S
        mask = (torch.arange(S, device=dev)[None, :] < lengths[:, None]).to(torch.int32)
        return q, k, v, pos_k, pos_q, mask

    # (rows, bucket) as the main path launches them: full 128-row batches of
    # short prompts, and the 16 long texts of the 512 bucket.
    for B, S in K1_SUMMED_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            args = inputs(gen, B, S, dtype)
            FA.launches = FA.launches_flash_tc = 0
            out = FA.flash_disentangled_attention(*args, scale)
            variant, tc = FA.kernel_variant(dtype), int(dtype == torch.bfloat16)
            if (FA.launches, FA.launches_flash_tc) != (1, tc):
                fail(f"K1 S={S} {dtype}: {FA.launches} launches, {FA.launches_flash_tc} on tensor cores; "
                     f"expected 1 and {tc}")
            ref = FA.flash_disentangled_attention_plain(*args, scale)
            torch.cuda.synchronize()
            if not torch.isfinite(out.float()).all():
                fail(f"K1 S={S} {dtype}: non-finite output")
            err = (out.float() - ref.float()).abs().max().item()
            log(f"K1 flash_disentangled_attention [{variant}] B={B} h={h} S={S} d={d} {str(dtype)[6:]}: "
                f"max|kernel-plain|={err:.3e} (tol {tol[dtype]:.0e})")
            if err > tol[dtype]:
                fail(f"K1 S={S} {dtype}: max error {err} above {tol[dtype]}")
            if dtype != torch.bfloat16:
                continue
            worst = max(worst, err)
            ms = time_ms(lambda: FA.flash_disentangled_attention(*args, scale))
            cc = cuda_core_ms("gct_flash_disentangled_attention", *args[:3], args[3:5], args[5], scale)
            plain = time_ms(lambda: FA.flash_disentangled_attention_plain(*args, scale), iters=10)
            lib = sdpa_rel_ms(*args, scale)
            # Work the function needs: qk, c2p, p2c and P.v, 2*S*S*d each.
            bms, by, ops, nbytes = attention_bound(B, S, 2 * h * (2 * S - 1) * d * 2)
            log(f"   time: kernel {ms:.4f} ms | CUDA-core variant {cc:.4f} ms | plain {plain:.4f} ms | "
                f"scaled_dot_product_attention {lib:.4f} ms | bound {bms:.4f} ms ({by})")
            for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib), ("cuda_core_ms", cc),
                             ("ops", ops), ("nbytes", nbytes)):
                tot[key] += val
            del args, out, ref
            torch.cuda.empty_cache()
    # Every shape "auto" sends to K1 on the main path (phase 3; [16, 512]
    # above), with their ragged last query and key tiles, held against the
    # plain version and timed (inputs from a generator of their own, so later
    # checks draw as before).
    g = torch.Generator(device=dev).manual_seed(seed + 11)
    for B, S in K1_MAIN_SHAPES:
        args = inputs(g, B, S, torch.bfloat16)
        out = FA.flash_disentangled_attention(*args, scale)
        ref = FA.flash_disentangled_attention_plain(*args, scale)
        torch.cuda.synchronize()
        if not torch.isfinite(out.float()).all():
            fail(f"K1 [{B}, {S}] bf16: non-finite output")
        err = (out.float() - ref.float()).abs().max().item()
        if err > tol[torch.bfloat16]:
            fail(f"K1 [{B}, {S}] bf16: max error {err} above {tol[torch.bfloat16]}")
        worst = max(worst, err)
        ms = time_ms(lambda: FA.flash_disentangled_attention(*args, scale))
        cc = cuda_core_ms("gct_flash_disentangled_attention", *args[:3], args[3:5], args[5], scale)
        lib = sdpa_rel_ms(*args, scale)
        bms, by, _, _ = attention_bound(B, S, 2 * h * (2 * S - 1) * d * 2)
        log(f"K1 main-path shape [{B}, {S}] bf16: max|kernel-plain|={err:.3e} (tol {tol[torch.bfloat16]:.0e}) | "
            f"kernel {ms:.4f} ms | CUDA-core variant {cc:.4f} ms | scaled_dot_product_attention {lib:.4f} ms | "
            f"bound {bms:.4f} ms ({by})")
        del args, out, ref
    bms, by = bound_ms(tot["ops"], "bf16", tot["nbytes"])
    return dict(ms=tot["ms"], plain_ms=tot["plain_ms"], library_ms=tot["library_ms"], bound_ms=bms, bound_by=by,
                max_abs_err=worst, variant=FA.TENSOR_CORE, cuda_core_ms=tot["cuda_core_ms"],
                shape="sum of B=128 S=56, B=128 S=128, B=16 S=512 (h=12 d=64 bf16)")


def check_ffn(gen: torch.Generator, dev, rng: np.random.Generator, seed: int) -> dict:
    from gliclass.c_tpu_torch.ops import _build
    from gliclass.c_tpu_torch.ops import fused_ffn as FF
    from gliclass.c_tpu_torch.ops.quant import quantize_weight

    # (M, H, I, timed): gliclass-base's FFN at M = 8192 (drawn from ``rng``
    # and ``gen`` as before the variant came), then a row count that is not a
    # multiple of the 128-row tiles (generators of its own). Both take the
    # tensor-core variant, which must equal the CUDA-core K2 bit for bit.
    rec = None
    rng2, gen2 = np.random.default_rng([seed, 12]), torch.Generator(device=dev).manual_seed(seed + 12)
    for M, H, I, timed in ((8192, 768, 3072, True), (300, 768, 3072, False)):
        r, g = (rng, gen) if timed else (rng2, gen2)
        wu, su = quantize_weight(r.normal(0, 0.02, (H, I)).astype(np.float32))
        wd, sd = quantize_weight(r.normal(0, 0.02, (I, H)).astype(np.float32))
        t = lambda a: torch.from_numpy(a).to(dev)
        wu, su, wd, sd = t(wu), t(su), t(wd), t(sd)
        bu = t(r.normal(0, 0.02, I).astype(np.float32))
        bd = t(r.normal(0, 0.02, H).astype(np.float32))
        x = torch.randn(M, H, generator=g, device=dev).to(torch.bfloat16)
        args = (x, wu, su, bu, wd, sd, bd, "gelu")
        wt = dict(wt_up=FF.nk_weight(wu), wt_dn=FF.nk_weight(wd))  # as the engine makes them, once
        FF.launches = FF.launches_tc = 0
        out = FF.fused_ffn_w8a8(*args, **wt)
        variant, tc = FF.kernel_variant(H, I), int(H % 16 == 0 and I % 16 == 0)
        if (FF.launches, FF.launches_tc) != (1, tc):
            fail(f"K2 M={M}: {FF.launches} calls, {FF.launches_tc} on tensor cores; expected 1 and {tc}")
        ref = FF.fused_ffn_w8a8_plain(*args)
        # The CUDA-core variant on the same inputs, its C entry called directly
        # (the wrapper sends H, I multiples of 16 to tensor cores).
        cc_out = torch.empty_like(x)
        cc_args = (*(a.data_ptr() for a in args[:7]), cc_out.data_ptr(), M, H, I, _build.stream_ptr(x))
        cc_fn = lambda: _build.check(_build.lib().gct_fused_ffn_w8a8(*cc_args), "gct_fused_ffn_w8a8")
        cc_fn()
        torch.cuda.synchronize()
        if not torch.isfinite(out.float()).all():
            fail(f"K2 M={M}: non-finite output")
        err = (out.float() - ref.float()).abs().max().item()
        scale_ref = ref.float().abs().max().item()
        # bf16 output: a few ulps at the output's magnitude, plus the rare int8
        # re-quantization flip where the kernel's and PyTorch's tanh differ.
        tol = 4 * 2.0 ** (math.floor(math.log2(scale_ref)) - 7)
        same = torch.equal(out, cc_out)
        log(f"K2 fused_ffn_w8a8 [{variant}] M={M} H={H} I={I}: max|kernel-plain|={err:.3e} "
            f"(tol {tol:.3e}, max|y| {scale_ref:.3f}); {'equal' if same else 'DIFFERENT'} to the CUDA-core K2 "
            f"bit for bit (max|diff| {(out.float() - cc_out.float()).abs().max().item():.3e})")
        if err > tol:
            fail(f"K2 M={M}: max error {err} above {tol}")
        if not same:
            fail(f"K2 M={M}: the tensor-core variant differs from the CUDA-core one")
        if not timed:
            continue
        # Through the wrapper with the engine's [N, K] weights, as on the main
        # path; beside it the profiler's device time of the four launches of
        # the tensor-core C entry, by kernel.
        tc_out = torch.empty_like(x)
        tc_args, scratch = FF.w8a8_tc_args(x, wt["wt_up"], su, bu, wt["wt_dn"], sd, bd, tc_out)
        tc_fn = lambda: _build.check(_build.lib().gct_fused_ffn_w8a8_tc(*tc_args), "gct_fused_ffn_w8a8_tc")
        ms = time_ms(lambda: FF.fused_ffn_w8a8(*args, **wt))
        entry = time_ms(tc_fn)
        by_kernel = device_ms_by_kernel(tc_fn)
        dms = sum(by_kernel.values()) if by_kernel else None
        cc = time_ms(cc_fn)
        plain = time_ms(lambda: FF.fused_ffn_w8a8_plain(*args), iters=10)
        ops = 4.0 * M * H * I
        nbytes = M * H * 2 * 2 + 2 * H * I + (I + H) * 4 * 2
        bms, by = bound_ms(ops, "int8", nbytes)
        log(f"   time: kernel {ms:.4f} ms (C entry {entry:.4f} ms, device {fmt_ms(dms)}: " + ", ".join(
            f"{k} {v:.4f}" for k, v in by_kernel.items()) + f") | CUDA-core variant {cc:.4f} ms (C entry) | "
            f"plain {plain:.4f} ms | bound {bms:.4f} ms ({by}) | library: none (no one PyTorch call computes "
            "up, gelu, re-quantization and down)")
        rec = dict(ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, max_abs_err=err, variant=variant,
                   cuda_core_ms=cc, entry_ms=entry, device_ms=dms, shape=f"M={M} H={H} I={I}")
    return rec


def check_int8_matmul(gen: torch.Generator, dev, rng: np.random.Generator, seed: int) -> dict:
    from gliclass.c_tpu_torch.ops import _build
    from gliclass.c_tpu_torch.ops import int8_matmul as IM
    from gliclass.c_tpu_torch.ops.quant import quantize_weight

    bf, f32 = torch.bfloat16, torch.float32
    M = 8192
    shapes = {"qkv": (768, 2304), "o": (768, 768), "up": (768, 3072), "down": (3072, 768)}
    # (label, M, K, N, dtype, bias): the encoder's four linears at M = 8192 in
    # bf16 (tensor cores; timed, and drawn from ``rng`` as before the variant
    # came, so that later phases draw the same weights and job), then, from
    # generators of their own: the rel-embedding projection (M = 512, 64-wide
    # tiles), a ragged M, the head's few rows, qwen-1.5B's N = 256 k/v
    # projection; a shape the tensor-core variant does not take (N = 40) and
    # fp32 (CUDA cores, 1e-4).
    cases = [(name, M, K, N, bf, True) for name, (K, N) in shapes.items()] + [
        ("rel-embedding qkv", 512, 768, 2304, bf, True), ("ragged M", 1000, 768, 768, bf, False),
        ("head", 16, 768, 3072, bf, True), ("qwen k/v", 300, 1536, 256, bf, True), ("N=40", 70, 96, 40, bf, True),
        ("qkv fp32", M, 768, 2304, f32, True), ("o fp32", 1000, 768, 768, f32, False)]
    rng2 = np.random.default_rng([seed, 3])
    gen2 = torch.Generator(device=dev).manual_seed(seed + 3)
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, cuda_core_ms=0.0, ops=0.0, nbytes=0.0)
    worst = 0.0
    for i, (name, M, K, N, dtype, with_bias) in enumerate(cases):
        r, g = (rng, gen) if i < len(shapes) else (rng2, gen2)
        w_q, scale = quantize_weight(r.normal(0, 0.02, (K, N)).astype(np.float32))
        w_q, scale = torch.from_numpy(w_q).to(dev), torch.from_numpy(scale).to(dev)
        bias = torch.from_numpy(r.normal(0, 0.02, N).astype(np.float32)).to(dev) if with_bias else None
        x = torch.randn(M, K, generator=g, device=dev).to(dtype)
        IM.launches = IM.launches_tc = 0
        out = IM.int8_matmul(x, w_q, scale, bias)
        variant, tc = IM.kernel_variant(dtype, K, N), int(dtype == bf and K % 8 == 0 and N % 16 == 0)
        if (IM.launches, IM.launches_tc) != (1, tc):
            fail(f"K3 {name}: {IM.launches} launches, {IM.launches_tc} on tensor cores; expected 1 and {tc}")
        ref = IM.int8_matmul_plain(x, w_q, scale, bias)
        torch.cuda.synchronize()
        if not torch.isfinite(out.float()).all():
            fail(f"K3 {name}: non-finite output")
        err = (out.float() - ref.float()).abs().max().item()
        mx = ref.float().abs().max().item()
        # bf16: the same fp32 sum in another order, rounded once to bf16: 1 ulp.
        tol = 2.0 ** (math.floor(math.log2(mx)) - 7) if dtype == bf else 1e-4
        log(f"K3 int8_matmul [{variant}] {name} M={M} K={K} N={N} {str(dtype)[6:]}"
            f"{'' if with_bias else ' no bias'}: max|kernel-plain|={err:.3e} (tol {tol:.3e})")
        if err > tol:
            fail(f"K3 {name}: max error {err} above {tol}")
        if i >= len(shapes):
            continue
        worst = max(worst, err)
        w_deq = (w_q.float() * scale).to(torch.bfloat16)  # yardstick only
        ms = time_ms(lambda: IM.int8_matmul(x, w_q, scale, bias))
        # The CUDA-core variant on the same bf16 inputs, its C entry called
        # directly (the wrapper sends these to tensor cores).
        cc_out = torch.empty_like(out)
        cc_args = (1, x.data_ptr(), w_q.data_ptr(), scale.data_ptr(), bias.data_ptr(), cc_out.data_ptr(), M, N, K,
                   _build.stream_ptr(x))
        cc = time_ms(lambda: _build.check(_build.lib().gct_int8_matmul(*cc_args), "gct_int8_matmul"))
        plain = time_ms(lambda: IM.int8_matmul_plain(x, w_q, scale, bias), iters=10)
        lib = time_ms(lambda: torch.matmul(x, w_deq))
        ops, nbytes = 2.0 * M * N * K, M * K * 2 + K * N + N * 8 + M * N * 2
        bms, by = bound_ms(ops, "bf16", nbytes)
        log(f"   time: kernel {ms:.4f} ms | CUDA-core variant {cc:.4f} ms | plain {plain:.4f} ms | "
            f"torch.matmul(bf16 dequantized) {lib:.4f} ms | bound {bms:.4f} ms ({by})")
        for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib), ("cuda_core_ms", cc), ("ops", ops),
                         ("nbytes", nbytes)):
            tot[key] += val
    bms, by = bound_ms(tot["ops"], "bf16", tot["nbytes"])
    return dict(ms=tot["ms"], plain_ms=tot["plain_ms"], library_ms=tot["library_ms"],
                bound_ms=bms, bound_by=by, max_abs_err=worst, variant=IM.TENSOR_CORE,
                cuda_core_ms=tot["cuda_core_ms"], shape="sum of qkv, o, up, down at M=8192 (bf16)")


def check_ffn_wonly(gen: torch.Generator, dev, rng: np.random.Generator) -> dict:
    from gliclass.c_tpu_torch.ops import _build
    from gliclass.c_tpu_torch.ops import fused_ffn as FF
    from gliclass.c_tpu_torch.ops.quant import quantize_weight

    # (M, H, I, timed): gliclass-base's FFN at M = 8192 (tensor cores; drawn
    # from ``rng`` and ``gen`` first, as before the variant came), then a
    # shape the tensor-core variant does not take (CUDA cores).
    rec = None
    for M, H, I, timed in ((8192, 768, 3072, True), (300, 100, 196, False)):
        wu, su = quantize_weight(rng.normal(0, 0.02, (H, I)).astype(np.float32))
        wd, sd = quantize_weight(rng.normal(0, 0.02, (I, H)).astype(np.float32))
        t = lambda a: torch.from_numpy(a).to(dev)
        bu = t(rng.normal(0, 0.02, I).astype(np.float32))
        bd = t(rng.normal(0, 0.02, H).astype(np.float32))
        x = torch.randn(M, H, generator=gen, device=dev).to(torch.bfloat16)
        args = (x, t(wu), t(su), bu, t(wd), t(sd), bd, "gelu")
        FF.launches_wonly = FF.launches_wonly_tc = 0
        out = FF.fused_ffn_wonly(*args)
        variant, tc = FF.kernel_variant(H, I), int(H % 16 == 0 and I % 16 == 0)
        if (FF.launches_wonly, FF.launches_wonly_tc) != (1, tc):
            fail(f"K4 M={M} H={H} I={I}: {FF.launches_wonly} calls, {FF.launches_wonly_tc} on tensor cores; "
                 f"expected 1 and {tc}")
        ref = FF.fused_ffn_wonly_plain(*args)
        torch.cuda.synchronize()
        if not torch.isfinite(out.float()).all():
            fail("K4: non-finite output")
        # bf16 output: a few ulps at the output's magnitude; the fp32 sums
        # differ in order, which can move one bf16 step of the rounded
        # intermediate (either variant).
        tol = 4 * 2.0 ** (math.floor(math.log2(ref.float().abs().max().item())) - 7)
        errs = {variant: (out.float() - ref.float()).abs().max().item()}
        # The CUDA-core variant on the same bf16 inputs, its C entry called
        # directly (the wrapper sends H, I multiples of 16 to tensor cores).
        cc_out = torch.empty_like(x)
        cc_args = (*(a.data_ptr() for a in args[:7]), cc_out.data_ptr(), M, H, I, _build.stream_ptr(x))
        cc_fn = lambda: _build.check(_build.lib().gct_fused_ffn_wonly(*cc_args), "gct_fused_ffn_wonly")
        if tc:
            cc_fn()
            torch.cuda.synchronize()
            errs[FF.CUDA_CORE] = (cc_out.float() - ref.float()).abs().max().item()
        log(f"K4 fused_ffn_wonly [{variant}] M={M} H={H} I={I}: max|kernel-plain|=" + ", ".join(
            f"{e:.3e} ({v})" for v, e in errs.items()) + f" (tol {tol:.3e}, 4 bf16 ulps of max|y|)")
        for v, e in errs.items():
            if e > tol:
                fail(f"K4 {v} M={M} H={H} I={I}: max error {e} above {tol}")
        if not timed:
            continue
        # Through the wrapper, as every kernel of the line; beside it the
        # tensor-core variant's C entry with its arguments built once (the
        # wrapper's host work left out) and its device time.
        h_buf, tc_out = torch.empty((M, I), dtype=x.dtype, device=dev), torch.empty_like(x)
        tc_args = (*cc_args[:7], h_buf.data_ptr(), tc_out.data_ptr(), M, H, I, _build.stream_ptr(x))
        tc_fn = lambda: _build.check(_build.lib().gct_fused_ffn_wonly_tc(*tc_args), "gct_fused_ffn_wonly_tc")
        ms = time_ms(lambda: FF.fused_ffn_wonly(*args))
        entry, dms = time_ms(tc_fn), device_ms(tc_fn)
        cc = time_ms(cc_fn)
        plain = time_ms(lambda: FF.fused_ffn_wonly_plain(*args), iters=10)
        ops = 4.0 * M * H * I
        nbytes = M * H * 2 * 2 + 2 * H * I + (I + H) * 4 * 2
        bms, by = bound_ms(ops, "bf16", nbytes)
        log(f"   time: kernel {ms:.4f} ms (C entry {entry:.4f} ms, device {fmt_ms(dms)}) | CUDA-core variant "
            f"{cc:.4f} ms (C entry) | plain {plain:.4f} ms | bound {bms:.4f} ms ({by}) | "
            "library: none (no one PyTorch call computes up, gelu and down)")
        rec = dict(ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by, max_abs_err=errs[variant],
                   variant=variant, cuda_core_ms=cc, entry_ms=entry, device_ms=dms, shape=f"M={M} H={H} I={I}")
    return rec


def check_causal(gen: torch.Generator, dev) -> dict:
    from gliclass.c_tpu_torch.ops import _build
    from gliclass.c_tpu_torch.ops import causal_attention as CA

    d = 128
    # bf16 runs the tensor-core variant: fp32 sums in another order, p rounded
    # to bf16 at the running max, exp by ex2.approx and one reciprocal per
    # row; fp32 the CUDA-core one.
    tol = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    tot = dict(ms=0.0, entry_ms=0.0, device_ms=0.0, plain_ms=0.0, library_ms=0.0, library_device_ms=0.0,
               cuda_core_ms=0.0, ops=0.0, nbytes=0.0)
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
            CA.launches = CA.launches_tc = 0
            out = CA.causal_flash_attention(qg, k, v, mask, scale)
            variant, tc = CA.kernel_variant(dtype, d), int(dtype == torch.bfloat16)
            if (CA.launches, CA.launches_tc) != (1, tc):
                fail(f"K5 {label} S={S} {dtype}: {CA.launches} launches, {CA.launches_tc} on tensor cores; "
                     f"expected 1 and {tc}")
            ref = CA.causal_flash_attention_plain(qg, k, v, mask, scale)
            torch.cuda.synchronize()
            if not torch.isfinite(out.float()).all():
                fail(f"K5 {label} S={S} {dtype}: non-finite output")
            err = (out.float() - ref.float()).abs().max().item()
            log(f"K5 causal_flash_attention [{variant}] {label} B={B} nkv={nkv} g={g} S={S} d={d} "
                f"{str(dtype)[6:]}: max|kernel-plain|={err:.3e} (tol {tol[dtype]:.0e})")
            if err > tol[dtype]:
                fail(f"K5 {label} S={S} {dtype}: max error {err} above {tol[dtype]}")
            if dtype != torch.bfloat16 or not timed:
                continue
            worst = max(worst, err)
            # Through the wrapper, as every kernel of the line; beside it the
            # tensor-core variant's C entry with its arguments built once (the
            # wrapper's host work left out) and its device time, and the
            # CUDA-core variant's C entry on the same bf16 inputs.
            entry_out = torch.empty((B, S, nh, d), dtype=dtype, device=dev)
            entry_args = (qg.data_ptr(), *qg.stride()[:4], k.data_ptr(), *k.stride()[:3], v.data_ptr(),
                          *v.stride()[:3], mask.data_ptr(), entry_out.data_ptr(), B, nkv, g, S, d, scale,
                          _build.stream_ptr(qg))
            lib = _build.lib()
            tc_fn = lambda: _build.check(lib.gct_causal_flash_attention_tc(*entry_args),
                                         "gct_causal_flash_attention_tc")
            ms = time_ms(lambda: CA.causal_flash_attention(qg, k, v, mask, scale))
            entry, dms = time_ms(tc_fn), device_ms(tc_fn)
            cc = time_ms(lambda: _build.check(lib.gct_causal_flash_attention(1, *entry_args),
                                              "gct_causal_flash_attention"))
            plain = time_ms(lambda: CA.causal_flash_attention_plain(qg, k, v, mask, scale), iters=5)
            # Yardstick only: one PyTorch call for the same function.
            q4 = qg.reshape(B, nh, S, d)
            causal = torch.ones(S, S, dtype=torch.bool, device=dev).tril()
            amask = causal[None, None] & (mask > 0)[:, None, None, :]
            sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
                q4, k, v, attn_mask=amask, enable_gqa=True)
            try:
                sdpa_ms, sdpa_dms = time_ms(sdpa), device_ms(sdpa)
            except TypeError as e:  # a PyTorch without enable_gqa
                lib_ok = False
                sdpa_ms, sdpa_dms = float("nan"), None
                log(f"   library: scaled_dot_product_attention(enable_gqa=True) unavailable: {e}")
            # Work this data needs: q.k and P.v over the valid keys j <= i of
            # every query row, 2 operations per multiply-add.
            pairs = float(mask.cumsum(dim=1).sum().item())
            ops = 4.0 * d * nh * pairs
            nbytes = (2 * B * nh * S * d + 2 * B * nkv * S * d) * 2 + B * S * 4
            bms, by = bound_ms(ops, "bf16", nbytes)
            log(f"   time: kernel {ms:.4f} ms (C entry {entry:.4f} ms, device {fmt_ms(dms)}) | CUDA-core variant "
                f"{cc:.4f} ms (C entry) | plain {plain:.4f} ms | scaled_dot_product_attention(enable_gqa) "
                f"{sdpa_ms:.4f} ms (device {fmt_ms(sdpa_dms)}) | bound {bms:.4f} ms ({by})")
            for key, val in (("ms", ms), ("entry_ms", entry), ("device_ms", dms), ("plain_ms", plain),
                             ("library_ms", sdpa_ms), ("library_device_ms", sdpa_dms), ("cuda_core_ms", cc),
                             ("ops", ops), ("nbytes", nbytes)):
                # A device time the profiler did not record leaves its sum unmeasured.
                tot[key] = None if tot[key] is None or val is None else tot[key] + val
    bms, by = bound_ms(tot["ops"], "bf16", tot["nbytes"])
    return dict(ms=tot["ms"], plain_ms=tot["plain_ms"], library_ms=tot["library_ms"] if lib_ok else None,
                bound_ms=bms, bound_by=by, max_abs_err=worst, variant=CA.TENSOR_CORE,
                cuda_core_ms=tot["cuda_core_ms"], entry_ms=tot["entry_ms"], device_ms=tot["device_ms"],
                library_device_ms=tot["library_device_ms"],
                shape="sum of B=64 S=128, B=16 S=512 (nkv=2 g=6 d=128 bf16)")


def unaligned_copy(t: torch.Tensor) -> torch.Tensor:
    """t's values in a contiguous tensor that starts one element past a
    16-byte boundary (the kernels' element-wise paths)."""
    u = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(t.shape)
    u.copy_(t)
    if u.data_ptr() % 16 == 0:
        fail("unaligned_copy: the copy is 16-byte aligned")
    return u


def check_copy(name: str, label: str, out: torch.Tensor, ref: torch.Tensor) -> float:
    """A copy of values: the kernel must equal its plain version exactly."""
    torch.cuda.synchronize()
    same = out.shape == ref.shape and torch.equal(out, ref)
    err = (out.float() - ref.float()).abs().max().item() if out.shape == ref.shape else float("inf")
    log(f"{name} {label}: {'equal' if same else 'DIFFERENT'} to its plain version (max|diff| {err:.3e}, "
        "tol 0: exact)")
    if not same:
        fail(f"{name} {label}: kernel differs from its plain version")
    return err


def check_abs_pos_table(gen: torch.Generator, dev) -> dict:
    from gliclass.c_tpu_torch.ops import _build
    from gliclass.c_tpu_torch.ops import fused_attention as FA

    h, d = 12, 64
    rec, by_shape = None, {}
    for S in (56, 72, 88, 128, 512):  # the serve path's buckets (56, 72, 88, 512) and the route phase's 128
        for dtype in (torch.float32, torch.bfloat16):
            pos = torch.randn(h, 2 * S - 1, d, generator=gen, device=dev).to(dtype)
            label = f"abs_pos_table h={h} S={S} d={d} {str(dtype)[6:]}"
            err = check_copy("K6", label, FA.abs_pos_table(pos, S), FA.abs_pos_table_plain(pos, S))
            if S == 128:  # pos_rel one element past a 16-byte boundary: element-wise staging loads
                check_copy("K6", label + " unaligned", FA.abs_pos_table(unaligned_copy(pos), S),
                           FA.abs_pos_table_plain(pos, S))
            if dtype != torch.bfloat16:
                continue
            # Through the wrapper, as every kernel of the line; beside it the C
            # entry with its arguments and output built once, and the
            # profiler's device time.
            idx = FA.rel_index(S, dev)
            out = torch.empty(h, S, d, S, dtype=dtype, device=dev)
            c_args = (1, pos.data_ptr(), out.data_ptr(), h, S, d, _build.stream_ptr(pos))
            entry_fn = lambda: _build.check(_build.lib().gct_abs_pos_table(*c_args), "gct_abs_pos_table")
            ms, entry, dms = time_ms(lambda: FA.abs_pos_table(pos, S)), time_ms(entry_fn), device_ms(entry_fn)
            lib = time_ms(lambda: pos[:, idx])  # one gather, [h, S, S, d] layout
            nbytes = h * (2 * S - 1) * d * 2 + h * S * S * d * 2
            bms, by = bound_ms(0.0, "bf16", nbytes)
            log(f"   time: kernel {ms:.4f} ms (C entry {entry:.4f} ms, device {fmt_ms(dms)}) | "
                f"pos_rel[:, idx] {lib:.4f} ms | bound {bms:.4f} ms ({by}, {nbytes / 1e6:.1f} MB)")
            if S != 512:
                by_shape[f"S={S}"] = dict(ms=ms, entry_ms=entry, device_ms=dms, library_ms=lib, bound_ms=bms)
                continue
            plain = time_ms(lambda: FA.abs_pos_table_plain(pos, S), iters=10)
            log(f"   plain {plain:.4f} ms")
            rec = dict(ms=ms, entry_ms=entry, device_ms=dms, plain_ms=plain, library_ms=lib, bound_ms=bms,
                       bound_by=by, max_abs_err=err, shape=f"one table, h={h} S={S} d={d} bf16")
    rec["by_shape"] = by_shape
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
    # The tensor-core variant's exp (ex2.approx) and one reciprocal per row
    # stay within the same bf16 bound.
    tol = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, cuda_core_ms=0.0, ops=0.0, nbytes=0.0)
    worst = 0.0
    # (B, S, dtype, ragged, timed): the two 512-bucket batches of the route
    # measurement, a ragged short bucket, and fp32; bf16 runs the tensor-core
    # variant, fp32 the CUDA-core one. Last, the tensor-core variant's 16-row
    # blocks at S = 1024 and 2048.
    cases = ((128, 512, torch.bfloat16, True, True), (16, 512, torch.bfloat16, True, True),
             (16, 88, torch.bfloat16, True, False), (16, 88, torch.float32, True, False),
             (8, 512, torch.float32, True, False), (4, 1024, torch.bfloat16, True, False),
             (2, 2048, torch.bfloat16, True, False))
    for B, S, dtype, ragged, timed in cases:
        q, k, v, c2p, p2c, mask = bias_inputs(gen, dev, B, S, dtype, ragged)
        FA.launches_bias = FA.launches_bias_tc = 0
        out = FA.bias_fused_attention(q, k, v, c2p, p2c, mask, scale)
        variant, tc = FA.kernel_variant(dtype, c2p.dtype), int(dtype == torch.bfloat16)
        if (FA.launches_bias, FA.launches_bias_tc) != (1, tc):
            fail(f"K7 B={B} S={S} {dtype}: {FA.launches_bias} launches, {FA.launches_bias_tc} on tensor cores; "
                 f"expected 1 and {tc}")
        ref = FA.bias_fused_attention_plain(q, k, v, c2p, p2c, mask, scale)
        torch.cuda.synchronize()
        if not torch.isfinite(out.float()).all():
            fail(f"K7 B={B} S={S} {dtype}: non-finite output")
        err = (out.float() - ref.float()).abs().max().item()
        log(f"K7 bias_fused_attention [{variant}] B={B} h={h} S={S} d={d} {str(dtype)[6:]} "
            f"{'ragged keys' if ragged else 'full'}: max|kernel-plain|={err:.3e} (tol {tol[dtype]:.0e})")
        if err > tol[dtype]:
            fail(f"K7 B={B} S={S} {dtype}: max error {err} above {tol[dtype]}")
        del ref
        if not timed:
            continue
        worst = max(worst, err)
        ms = time_ms(lambda: FA.bias_fused_attention(q, k, v, c2p, p2c, mask, scale))
        cc = cuda_core_bias_ms(q, k, v, c2p, p2c, mask, scale)
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
        log(f"   time: kernel {ms:.4f} ms | CUDA-core variant {cc:.4f} ms | plain {plain:.4f} ms | "
            f"scaled_dot_product_attention {lib:.4f} ms | bound {bms:.4f} ms ({by}, {nbytes / 1e9:.3f} GB)")
        for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib), ("cuda_core_ms", cc), ("ops", ops),
                         ("nbytes", nbytes)):
            tot[key] += val
        torch.cuda.empty_cache()
    bms, by = bound_ms(tot["ops"], "bf16", tot["nbytes"])
    return dict(ms=tot["ms"], plain_ms=tot["plain_ms"], library_ms=tot["library_ms"], bound_ms=bms,
                bound_by=by, max_abs_err=worst, variant=FA.TENSOR_CORE, cuda_core_ms=tot["cuda_core_ms"],
                shape="sum of B=128 S=512, B=16 S=512 (h=12 d=64 bf16)")


def cuda_core_bias_ms(q, k, v, c2p, p2c, mask, scale) -> float:
    """Time of the CUDA-core K7 on the same bf16 inputs, its C entry called
    directly (the wrapper sends bf16 to the tensor-core variant)."""
    from gliclass.c_tpu_torch.ops import _build

    B, h, S, d = q.shape
    out = torch.empty((B, S, h, d), dtype=q.dtype, device=q.device)
    args = (1, 1, q.data_ptr(), k.data_ptr(), v.data_ptr(), *q.stride()[:3], c2p.data_ptr(), *c2p.stride(),
            p2c.data_ptr(), *p2c.stride(), mask.data_ptr(), out.data_ptr(), B, h, S, 1.0 / scale,
            _build.stream_ptr(q))
    fn = _build.lib().gct_bias_fused_attention
    return time_ms(lambda: _build.check(fn(*args), "gct_bias_fused_attention"))


def rel_inputs(gen: torch.Generator, dev, B: int, S: int, dtype):
    """Inputs of the row and tiled routes as the model passes them: q/k/v
    head views of one [B, S, 3H] projection, the two [h, 2S-1, d] relative
    tables, and a key mask with ragged lengths (one full row)."""
    h, d = 12, 64
    H = h * d
    qkv = torch.randn(B, S, 3 * H, generator=gen, device=dev).to(dtype)
    q, k, v = (qkv[..., i * H:(i + 1) * H].reshape(B, S, h, d).transpose(1, 2) for i in range(3))
    pos_k, pos_q = (torch.randn(h, 2 * S - 1, d, generator=gen, device=dev).to(dtype) for _ in range(2))
    lengths = torch.randint(1, S + 1, (B,), generator=gen, device=dev)
    lengths[0] = S
    mask = (torch.arange(S, device=dev)[None, :] < lengths[:, None]).to(torch.int32)
    return q, k, v, pos_k, pos_q, mask


def sdpa_rel_ms(q, k, v, pos_k, pos_q, mask, scale) -> float:
    """Yardstick only: one scaled_dot_product_attention call for the same
    function, the additive mask (c2p + p2c) / scale (and the padded keys)
    summed outside the timed call, as for K7."""
    from gliclass.c_tpu_torch.ops import fused_attention as FA

    c2p, p2c = FA._rel_biases(q, k, pos_k, pos_q)
    bias = ((c2p + p2c) * (1.0 / scale)).masked_fill(mask[:, None, None, :] == 0, float("-inf")).to(q.dtype)
    del c2p, p2c
    ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=bias,
                                                                          scale=1.0 / scale))
    del bias
    torch.cuda.empty_cache()
    return ms


def cuda_core_ms(entry: str, q, k, v, tables, mask, scale, *extra) -> float:
    """Time of the CUDA-core K8 or K10 on the same bf16 inputs, its C entry
    called directly (the wrappers send bf16 to the tensor-core variants):
    the earlier version beside the new one, in the same call."""
    from gliclass.c_tpu_torch.ops import _build

    B, h, S, d = q.shape
    out = torch.empty((B, S, h, d), dtype=q.dtype, device=q.device)
    codes = (1,) * (2 if entry == "gct_tiled_disentangled_attention" else 1)
    fn = getattr(_build.lib(), entry)
    args = (*codes, q.data_ptr(), k.data_ptr(), v.data_ptr(), *q.stride()[:3], *(t.data_ptr() for t in tables),
            mask.data_ptr(), out.data_ptr(), B, h, S, *extra, 1.0 / scale, _build.stream_ptr(q))
    return time_ms(lambda: _build.check(fn(*args), entry))


def attention_bound(B: int, S: int, extra_bytes: float) -> tuple[float, str, float, float]:
    """Bound of the four-product attention kernels (q.k, c2p, p2c, p.v: 2*S*S*d
    operations each per (b, h)) on bf16 inputs: q, k, v read and out written
    once, the mask, and ``extra_bytes`` of tables."""
    h, d = 12, 64
    ops = B * h * 8.0 * S * S * d
    nbytes = 4 * B * h * S * d * 2 + B * S * 4 + extra_bytes
    return (*bound_ms(ops, "bf16", nbytes), ops, nbytes)


def check_row_attention(gen: torch.Generator, dev) -> dict:
    from gliclass.c_tpu_torch.ops import fused_attention as FA

    h, d = 12, 64
    scale = math.sqrt(d * 3)
    # bf16: as K7 (the same softmax): the fp32 score sums run in another order
    # than the plain version's matmuls and p is rounded to bf16 before p.v.
    tol = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, cuda_core_ms=0.0, ops=0.0, nbytes=0.0)
    worst = 0.0
    # (B, S, dtype, timed): the 512 bucket at the route phase's two batches, a
    # ragged short bucket (88: a part row tile and key tile), and fp32. bf16
    # runs the tensor-core variant, fp32 the CUDA-core one.
    cases = ((128, 512, torch.bfloat16, True), (16, 512, torch.bfloat16, True),
             (16, 88, torch.bfloat16, False), (16, 88, torch.float32, False), (8, 512, torch.float32, False))
    for B, S, dtype, timed in cases:
        args = rel_inputs(gen, dev, B, S, dtype)
        FA.launches_row = FA.launches_row_tc = 0
        out = FA.row_disentangled_attention(*args, scale)
        variant, tc = FA.kernel_variant(dtype), int(dtype == torch.bfloat16)
        if (FA.launches_row, FA.launches_row_tc) != (1, tc):
            fail(f"K8 B={B} S={S} {dtype}: {FA.launches_row} launches, {FA.launches_row_tc} on tensor cores; "
                 f"expected 1 and {tc}")
        ref = FA.row_disentangled_attention_plain(*args, scale)
        torch.cuda.synchronize()
        if not torch.isfinite(out.float()).all():
            fail(f"K8 B={B} S={S} {dtype}: non-finite output")
        err = (out.float() - ref.float()).abs().max().item()
        log(f"K8 row_disentangled_attention [{variant}] B={B} h={h} S={S} d={d} {str(dtype)[6:]} ragged keys: "
            f"max|kernel-plain|={err:.3e} (tol {tol[dtype]:.0e})")
        if err > tol[dtype]:
            fail(f"K8 B={B} S={S} {dtype}: max error {err} above {tol[dtype]}")
        del ref
        if not timed:
            continue
        worst = max(worst, err)
        ms = time_ms(lambda: FA.row_disentangled_attention(*args, scale))
        cc = cuda_core_ms("gct_row_disentangled_attention", *args[:3], args[3:5], args[5], scale)
        plain = time_ms(lambda: FA.row_disentangled_attention_plain(*args, scale), iters=5)
        lib = sdpa_rel_ms(*args, scale)
        bms, by, ops, nbytes = attention_bound(B, S, 2 * h * (2 * S - 1) * d * 2)
        log(f"   time: kernel {ms:.4f} ms | CUDA-core variant {cc:.4f} ms | plain {plain:.4f} ms | "
            f"scaled_dot_product_attention {lib:.4f} ms | bound {bms:.4f} ms ({by})")
        for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib), ("cuda_core_ms", cc),
                         ("ops", ops), ("nbytes", nbytes)):
            tot[key] += val
        torch.cuda.empty_cache()
    bms, by = bound_ms(tot["ops"], "bf16", tot["nbytes"])
    return dict(ms=tot["ms"], plain_ms=tot["plain_ms"], library_ms=tot["library_ms"], bound_ms=bms,
                bound_by=by, max_abs_err=worst, variant=FA.TENSOR_CORE, cuda_core_ms=tot["cuda_core_ms"],
                shape="sum of B=128 S=512, B=16 S=512 (h=12 d=64 bf16)")


def check_windowed_pos_table(gen: torch.Generator, dev) -> dict:
    from gliclass.c_tpu_torch.ops import _build
    from gliclass.c_tpu_torch.ops import fused_attention as FA

    h, d, blk = 12, 64, FA.TILED_BLK
    rec = None
    for S in (128, 512):
        for dtype in (torch.float32, torch.bfloat16):
            pos = torch.randn(h, 2 * S - 1, d, generator=gen, device=dev).to(dtype)
            label = f"windowed_pos_tables h={h} S={S} blk={blk} d={d} {str(dtype)[6:]}"
            err = check_copy("K9", label, FA.windowed_pos_tables(pos, blk), FA.windowed_pos_tables_plain(pos, blk))
            if S == 128:  # pos_rel one element past a 16-byte boundary: element-wise staging loads
                check_copy("K9", label + " unaligned", FA.windowed_pos_tables(unaligned_copy(pos), blk),
                           FA.windowed_pos_tables_plain(pos, blk))
            if S != 512 or dtype != torch.bfloat16:
                continue
            idx = FA._win_index(S, blk, dev).reshape(-1)
            out = torch.empty(h, 2 * (S // blk) - 1, blk, blk, d, dtype=dtype, device=dev)
            c_args = (1, pos.data_ptr(), out.data_ptr(), h, S, d, blk, _build.stream_ptr(pos))
            entry_fn = lambda: _build.check(_build.lib().gct_windowed_pos_table(*c_args), "gct_windowed_pos_table")
            ms, entry, dms = time_ms(lambda: FA.windowed_pos_tables(pos, blk)), time_ms(entry_fn), device_ms(entry_fn)
            plain = time_ms(lambda: FA.windowed_pos_tables_plain(pos, blk), iters=10)
            lib = time_ms(lambda: torch.index_select(pos, 1, idx))  # one gather, [h, w*x*y, d]
            nbytes = h * (2 * S - 1) * d * 2 + out.numel() * 2
            bms, by = bound_ms(0.0, "bf16", nbytes)
            log(f"   time: kernel {ms:.4f} ms (C entry {entry:.4f} ms, device {fmt_ms(dms)}) | plain {plain:.4f} ms "
                f"| index_select {lib:.4f} ms | bound {bms:.4f} ms ({by}, {nbytes / 1e6:.1f} MB)")
            rec = dict(ms=ms, entry_ms=entry, device_ms=dms, plain_ms=plain, library_ms=lib, bound_ms=bms,
                       bound_by=by, max_abs_err=err, shape=f"one table, h={h} S={S} blk={blk} d={d} bf16")
    return rec


def check_tiled_attention(gen: torch.Generator, dev) -> dict:
    from gliclass.c_tpu_torch.ops import fused_attention as FA

    h, d, blk = 12, 64, FA.TILED_BLK
    scale = math.sqrt(d * 3)
    # bf16: as K1 (the same online softmax): fp32 sums in another order, and
    # exp(s - m) rounded to bf16 at the running max, not the row's.
    tol = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, cuda_core_ms=0.0, ops=0.0, nbytes=0.0)
    worst = 0.0
    # (B, S, dtype, table dtype, timed): bf16 with bf16 tables (the main
    # path's case) runs the tensor-core variant; fp32 and mixed types the
    # CUDA-core one. B=17 leaves a group of 16 batch rows part full.
    bf, f32 = torch.bfloat16, torch.float32
    cases = ((128, 512, bf, bf, True), (16, 512, bf, bf, True), (17, 128, bf, bf, False),
             (16, 128, f32, f32, False), (16, 128, bf, f32, False), (8, 512, f32, f32, False))
    for B, S, dtype, table_dtype, timed in cases:
        q, k, v, pos_k, pos_q, mask = rel_inputs(gen, dev, B, S, dtype)
        twc = FA.windowed_pos_tables(pos_k.to(table_dtype), blk)
        twq = FA.windowed_pos_tables(pos_q.to(table_dtype), blk)
        args = (q, k, v, twc, twq, mask, scale)
        FA.launches_tiled = FA.launches_tiled_tc = 0
        out = FA.tiled_attention(*args)
        variant, tc = FA.kernel_variant(dtype, table_dtype), int(dtype == table_dtype == bf)
        if (FA.launches_tiled, FA.launches_tiled_tc) != (1, tc):
            fail(f"K10 B={B} S={S} {dtype}/{table_dtype}: {FA.launches_tiled} launches, {FA.launches_tiled_tc} "
                 f"on tensor cores; expected 1 and {tc}")
        ref = FA.tiled_attention_plain(*args)
        torch.cuda.synchronize()
        if not torch.isfinite(out.float()).all():
            fail(f"K10 B={B} S={S} {dtype}: non-finite output")
        err = (out.float() - ref.float()).abs().max().item()
        log(f"K10 tiled_attention [{variant}] B={B} h={h} S={S} d={d} blk={blk} {str(dtype)[6:]} "
            f"(tables {str(table_dtype)[6:]}) ragged keys: max|kernel-plain|={err:.3e} (tol {tol[dtype]:.0e})")
        if err > tol[dtype]:
            fail(f"K10 B={B} S={S} {dtype}: max error {err} above {tol[dtype]}")
        del ref
        torch.cuda.empty_cache()
        if not timed:
            continue
        worst = max(worst, err)
        ms = time_ms(lambda: FA.tiled_attention(*args))
        cc = cuda_core_ms("gct_tiled_disentangled_attention", q, k, v, (twc, twq), mask, scale, blk)
        plain = time_ms(lambda: FA.tiled_attention_plain(*args), iters=5)
        torch.cuda.empty_cache()
        lib = sdpa_rel_ms(q, k, v, pos_k, pos_q, mask, scale)
        bms, by, ops, nbytes = attention_bound(B, S, 2 * twc.numel() * 2)
        log(f"   time: kernel {ms:.4f} ms | CUDA-core variant {cc:.4f} ms | plain {plain:.4f} ms | "
            f"scaled_dot_product_attention {lib:.4f} ms | bound {bms:.4f} ms ({by})")
        for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib), ("cuda_core_ms", cc),
                         ("ops", ops), ("nbytes", nbytes)):
            tot[key] += val
    bms, by = bound_ms(tot["ops"], "bf16", tot["nbytes"])
    return dict(ms=tot["ms"], plain_ms=tot["plain_ms"], library_ms=tot["library_ms"], bound_ms=bms,
                bound_by=by, max_abs_err=worst, variant=FA.TENSOR_CORE, cuda_core_ms=tot["cuda_core_ms"],
                shape=f"sum of B=128 S=512, B=16 S=512 (h=12 d=64 bf16, tables blk={blk})")


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
            "bias_fused_attention": (fused_attention, "launches_bias"),
            "row_disentangled_attention": (fused_attention, "launches_row"),
            "windowed_pos_tables": (fused_attention, "launches_win_table"),
            "tiled_attention": (fused_attention, "launches_tiled"),
            # The tensor-core launches among those of K1, K2, K3, K4, K5, K7, K8 and K10.
            "flash_disentangled_attention_tc": (fused_attention, "launches_flash_tc"),
            "fused_ffn_w8a8_tc": (fused_ffn, "launches_tc"),
            "int8_matmul_tc": (int8_matmul, "launches_tc"),
            "fused_ffn_wonly_tc": (fused_ffn, "launches_wonly_tc"),
            "causal_flash_attention_tc": (causal_attention, "launches_tc"),
            "bias_fused_attention_tc": (fused_attention, "launches_bias_tc"),
            "row_disentangled_attention_tc": (fused_attention, "launches_row_tc"),
            "tiled_attention_tc": (fused_attention, "launches_tiled_tc")}


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
    for ms, n, key in rows[:20]:
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
             profile: bool = False, attn_route: str = "auto") -> tuple[dict, list]:
    """classify_job on the card: a warm pass, then three timed passes; the
    launch counts and the (rows, seq) of every forward of the first timed
    pass; the first ``n_cpu`` texts against the same port on the CPU (the
    same attention route, through the plain versions).

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
                       quant_mode=quant_mode, seq_buckets=SEQ_LADDER, label_buckets=(8,), attn_route=attn_route)
    job = parse_job(job_dict)
    engine = InferenceEngine(cfg, qparams, rt, device=dev)
    forwards = count_forwards(engine)
    pipe = ZeroShotClassificationPipeline(engine, tok, rt)
    t0 = time.perf_counter()
    pipe.classify_job(job)  # first pass: library handles, allocator growth
    torch.cuda.synchronize()
    cold = time.perf_counter() - t0
    gc.collect()  # engines of earlier paths (count_forwards makes a cycle) hold no memory in the peak
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    forwards.clear()
    t0 = time.perf_counter()
    out = pipe.classify_job(job)
    torch.cuda.synchronize()
    walls = [time.perf_counter() - t0]
    counts, shapes = read_counts(), list(forwards)
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
    log(f"   forwards: {len(shapes)} (rows x seq: {shapes}); launches: {json.dumps(counts)}")
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
    return counts, shapes


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


# Launches per layer of each attention route's kernels, in bf16 (where K1, K7,
# K8 and K10 run their tensor-core variants).
ROUTE_KERNELS = {
    "flash": {"flash_disentangled_attention": 1, "flash_disentangled_attention_tc": 1},
    "bias": {"abs_pos_table": 2, "bias_fused_attention": 1, "bias_fused_attention_tc": 1},
    "row": {"row_disentangled_attention": 1, "row_disentangled_attention_tc": 1},
    "tiled": {"windowed_pos_tables": 2, "tiled_attention": 1, "tiled_attention_tc": 1},
}


def expect_attention(counts: dict, shapes: list, L: int, label: str, route: str = "auto") -> None:
    """Each attention kernel ran exactly as often as the route that
    ``attention_route`` names for every (rows, seq) forward asks, L layers a
    forward, and the others not at all."""
    from gliclass.c_tpu_torch.ops.fused_attention import attention_route

    want = {name: 0 for per in ROUTE_KERNELS.values() for name in per}
    for rows, seq in shapes:
        for name, n in ROUTE_KERNELS[attention_route(seq, rows, 64, route)].items():
            want[name] += n * L
    for name, n in want.items():
        if counts[name] != n:
            fail(f"{label}: {name} launched {counts[name]} times, expected {n} "
                 f"(route {route!r} over forwards {shapes})")


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
        log(f"{r} route: 128 texts of the 512 bucket in {wall:.4f} s = {128 / wall:.1f} texts/s; "
            f"forwards {shapes}; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
            f"launches {json.dumps(counts[r])}")
        expect_attention(counts[r], shapes, L, f"{r} route", r)
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


ROUTES = ("flash", "bias", "row", "tiled")
# The 512 bucket at five batches, the 128 bucket at two, and the main job's
# short-text forwards: [128, 56], [128, 88], [128, 72], [64, 56], [32, 72].
FOUR_ROUTE_SHAPES = ((128, 512), (64, 512), (32, 512), (16, 512), (8, 512), (128, 128), (32, 128), (128, 56),
                     (128, 88), (128, 72), (64, 56), (32, 72))


def four_routes(cfg, qparams, tok, job_dict, rng: np.random.Generator, dev) -> dict:
    """The four DeBERTa attention routes on gliclass-base int8-dynamic at
    full width: classify_job on ``job_dict`` under "row" and under "tiled"
    (run_path: texts/s, forwards, peak memory, profile, agreement with the
    CPU) with the exact launch counts per forward; the whole forward at
    FOUR_ROUTE_SHAPES with the route forced (CUDA events, two turns in
    opposite orders); one forward of
    the 512 bucket under "tiled" launching K10; fp32 hidden states of row and
    tiled against flash."""
    from gliclass.c_tpu_torch.config import RuntimeConfig
    from gliclass.c_tpu_torch.engine import InferenceEngine
    from gliclass.c_tpu_torch.ops.fused_attention import attention_route
    from gliclass.c_tpu_torch.prompting import pack_prompts

    L = cfg.backbone.num_hidden_layers
    # classify_job first, so that each path's peak memory holds its own engine only.
    records = {}
    for r in ("row", "tiled"):
        counts, shapes = run_path(cfg, qparams, tok, job_dict, "int8-dynamic", dev, 8,
                                  f"classify_job attn_route={r}", profile=True, attn_route=r)
        records[r] = counts, shapes
        if not any(s == 512 for _, s in shapes):
            fail(f"{r} route: the job ran no forward in the 512 bucket")
        # row: K8 (tensor cores) in every forward; tiled: K9 twice and K10
        # (tensor cores) in the buckets that are multiples of 32, K1 in the others.
        expect_attention(counts, shapes, L, f"{r} route", r)
    rt = RuntimeConfig(batch_size=128, max_length=512, compute_dtype="bfloat16", quant_mode="int8-dynamic",
                       seq_buckets=SEQ_LADDER, label_buckets=(8,))
    engines = {"flash": InferenceEngine(cfg, qparams, dataclasses.replace(rt, attn_route="flash"), device=dev)}
    for r in ROUTES[1:]:
        engines[r] = InferenceEngine(cfg, engines["flash"].params, dataclasses.replace(rt, attn_route=r), device=dev)
    texts = {512: make_job(rng, 0, 128), 128: make_job(rng, 128, 0)}
    # Short texts cut to fill the 56, 88 and 72 buckets (8 labels take 19 tokens).
    for S, n_words in ((56, 30), (88, 60), (72, 45)):
        jd = make_job(rng, 128, 0)
        texts[S] = dict(jd, texts=[" ".join(tx.split()[:n_words]) for tx in jd["texts"]])
    batches, inputs = {}, {}
    for S, jd in texts.items():
        batches[S] = tok.encode_batch(pack_prompts(jd["texts"], jd["labels"], True, cfg.prompt_first),
                                      max_length=512, pad_to=S)
        if batches[S].seq_length != S:
            fail(f"four routes: texts meant for the {S} bucket pad to {batches[S].seq_length}")
        inputs[S] = engines["flash"]._device_inputs(batches[S].input_ids, batches[S].attention_mask)

    fwd, wins = {}, []
    for B, S in FOUR_ROUTE_SHAPES:
        ids, mask = (t[:B] for t in inputs[S])
        times = {r: [] for r in ROUTES}
        for order in (ROUTES, ROUTES[::-1]):
            for r in order:
                times[r].append(time_ms(lambda: engines[r]._forward(ids, mask, 8), iters=3, warmup=1))
        fwd[(B, S)] = {r: statistics.median(t) for r, t in times.items()}
        log(f"forward [{B}, {S}] gliclass-base int8-dynamic, route ms (median; turns "
            f"{'-'.join(ROUTES)} then reversed): " + "; ".join(
                f"{r} {fwd[(B, S)][r]:.3f} ({', '.join(f'{t:.3f}' for t in times[r])})" for r in ROUTES))
        for r in ROUTES:
            if all(times[r][t] < min(times[o][t] for o in ROUTES if o != r) for t in range(2)):
                wins.append(((B, S), r))
    log("fastest of the four routes in both turns (the \"auto\" rule's input): " + (str(wins) if wins else "nowhere"))
    log("auto route: " + ", ".join(f"[{B}, {S}] {attention_route(S, B, 64)}" for B, S in fwd))

    # The 512 bucket launches K10 (and K9 twice) in each of its 12 layers.
    reset_counts()
    engines["tiled"]._forward(*(t[:16] for t in inputs[512]), 8)
    torch.cuda.synchronize()
    counts = read_counts()
    log(f"one tiled forward at [16, 512]: launches {json.dumps(counts)}")
    expect_attention(counts, [(16, 512)], L, "tiled route, 512 bucket", "tiled")

    # fp32 (INT8 weight-only) hidden states of two texts, each route against flash.
    rt32 = dataclasses.replace(rt, compute_dtype="float32", quant_mode="int8")
    herr = {}
    for S in (512, 128):
        two = tok.encode_batch(pack_prompts(texts[S]["texts"][:2], texts[S]["labels"], True, cfg.prompt_first),
                               max_length=512, pad_to=S)
        valid = torch.from_numpy(two.attention_mask).bool()
        hs = {r: hidden_states(InferenceEngine(cfg, engines["flash"].params, dataclasses.replace(rt32, attn_route=r),
                                               device=dev), two) for r in ("flash", "row", "tiled")}
        for r in ("row", "tiled"):
            herr[(r, S)] = ((hs[r][valid] - hs["flash"][valid]).norm() / hs["flash"][valid].norm()).item()
    log("fp32 hidden states against the flash route on the card, 2 texts: " + "; ".join(
        f"{r} S={S} rel L2 {e:.3e}" for (r, S), e in herr.items()) + " (tol 1e-4)")
    for (r, S), e in herr.items():
        if not e <= 1e-4:
            fail(f"four routes: {r} and flash fp32 hidden states differ by {e} (relative) at S={S}")
    return records


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
    # The forwards of this pass (the profiled pass below records its own too).
    counts, shapes = read_counts(), list(shapes)
    n_fwd = len(shapes)
    with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/metrics", timeout=30) as resp:
        metrics = json.loads(resp.read())
    # The same traffic again under the profiler (device activity only), for
    # the device's busy share and its top kernels; latencies and counts come
    # from the pass above.
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, wall_prof = drive()
    rows = sorted(((e.self_device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0), reverse=True)
    busy = sum(r[0] for r in rows) / 1e3
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
    for ms, n, key in rows[:10]:
        log(f"      {ms:9.3f} ms  {100 * ms / (busy * 1e3):5.1f}%  x{n:<5d} {key[:90]}")
    k6 = [(ms, n) for ms, n, key in rows if "abs_pos_table_kernel" in key]
    if k6:
        log(f"   K6 in the profiled pass: {sum(r[0] for r in k6):.3f} ms over {sum(r[1] for r in k6)} launches")
    if metrics["requests"] != n_req or metrics["errors"] != 0:
        fail(f"serve path: /metrics counts {metrics['requests']} requests, {metrics['errors']} errors")
    if long_rows <= 16:
        fail(f"serve path: the 512 bucket saw at most {long_rows} rows, not above 16")
    expect_attention(counts, shapes, L, "serve path", "bias")

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
            "flash_disentangled_attention": check_attention(gen, dev, args.seed),
            "fused_ffn_w8a8": check_ffn(gen, dev, rng, args.seed),
            "int8_matmul": check_int8_matmul(gen, dev, rng, args.seed),
            # Generators of their own from here on, so that the gliclass-base
            # phases draw the same weights and job as before K4 and K5 came.
            "fused_ffn_wonly": check_ffn_wonly(gen, dev, np.random.default_rng([args.seed, 4])),
            "causal_flash_attention": check_causal(gen, dev),
            # Generators of their own again, for the same reason.
            "abs_pos_table": check_abs_pos_table(torch.Generator(device=dev).manual_seed(args.seed + 6), dev),
            "bias_fused_attention": check_bias_attention(torch.Generator(device=dev).manual_seed(args.seed + 7),
                                                         dev),
            "row_disentangled_attention": check_row_attention(
                torch.Generator(device=dev).manual_seed(args.seed + 8), dev),
            "windowed_pos_tables": check_windowed_pos_table(
                torch.Generator(device=dev).manual_seed(args.seed + 9), dev),
            "tiled_attention": check_tiled_attention(torch.Generator(device=dev).manual_seed(args.seed + 10), dev),
        }

    # Each kernel's launches come from the run of the path it serves; K3's,
    # K4's, K5's, K7's, K8's and K10's tensor-core launches among them in
    # launches_tc.
    launches, paths, launches_tc = {}, {}, {}
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
        counts, shapes = run_path(cfg, qparams, tok, job, "int8-dynamic", dev, 8,
                                  "main path int8-dynamic", profile=True)
        n_fwd = len(shapes)
        expect_launches(counts, "fused_ffn_w8a8", bb.num_hidden_layers * n_fwd, "main path")
        # Every K2 call of the path (H = 768, I = 3072) takes the tensor-core variant.
        expect_launches(counts, "fused_ffn_w8a8_tc", counts["fused_ffn_w8a8"], "main path")
        # The attention kernels of the route "auto" takes at each forward's
        # (rows, seq), every K1 launch on tensor cores.
        expect_attention(counts, shapes, bb.num_hidden_layers, "main path")
        from gliclass.c_tpu_torch.ops.fused_attention import attention_route

        unchecked = sorted({(B, S) for B, S in shapes if attention_route(S, B, 64) == "flash"}
                           - set(K1_SUMMED_SHAPES) - set(K1_MAIN_SHAPES))
        if unchecked:
            fail(f"main path: K1 ran at {unchecked}, which phase 2 did not hold against its plain version")
        launches["fused_ffn_w8a8"], paths["fused_ffn_w8a8"] = counts["fused_ffn_w8a8"], "gliclass-base int8-dynamic"
        launches_tc["fused_ffn_w8a8"] = counts["fused_ffn_w8a8_tc"]
        if counts["flash_disentangled_attention"]:
            launches["flash_disentangled_attention"] = counts["flash_disentangled_attention"]
            launches_tc["flash_disentangled_attention"] = counts["flash_disentangled_attention_tc"]
            paths["flash_disentangled_attention"] = "gliclass-base int8-dynamic"

    with phase("phase 4: gliclass-base weight-only int8"):
        sub = dict(job, texts=job["texts"][:128] + job["texts"][-4:])
        counts, shapes = run_path(cfg, qparams, tok, sub, "int8", dev, 4, "weight-only int8", profile=True)
        n_fwd = len(shapes)
        expect_launches(counts, "fused_ffn_wonly", bb.num_hidden_layers * n_fwd, "weight-only path")
        # Every K4 call of the path (H = 768, I = 3072) takes the tensor-core variant.
        expect_launches(counts, "fused_ffn_wonly_tc", counts["fused_ffn_wonly"], "weight-only path")
        expect_attention(counts, shapes, bb.num_hidden_layers, "weight-only path")
        # Every K3 linear of the path (qkv, the rel-embedding projection and o
        # of each layer, the head) takes the tensor-core variant in bf16.
        if counts["int8_matmul"] <= 0 or counts["int8_matmul_tc"] != counts["int8_matmul"]:
            fail(f"weight-only path launched int8_matmul {counts['int8_matmul']} times, "
                 f"{counts['int8_matmul_tc']} on tensor cores; expected all of them, and some")
        for name in ("int8_matmul", "fused_ffn_wonly"):
            launches[name], paths[name] = counts[name], "gliclass-base int8"
        launches_tc["int8_matmul"] = counts["int8_matmul_tc"]
        launches_tc["fused_ffn_wonly"] = counts["fused_ffn_wonly_tc"]

    with phase("phase 5: flash route against bias route, gliclass-base int8-dynamic at [128, 512]"):
        route_measurement(cfg, qparams, tok, np.random.default_rng([args.seed, 7]), dev)
        torch.cuda.empty_cache()

    with phase("phase 6: the four attention routes, gliclass-base int8-dynamic"):
        records = four_routes(cfg, qparams, tok, job, np.random.default_rng([args.seed, 9]), dev)
        counts, _ = records["row"]
        launches["row_disentangled_attention"] = counts["row_disentangled_attention"]
        launches_tc["row_disentangled_attention"] = counts["row_disentangled_attention_tc"]
        paths["row_disentangled_attention"] = "gliclass-base int8-dynamic classify_job, attn_route=row"
        counts, _ = records["tiled"]
        for name in ("windowed_pos_tables", "tiled_attention"):
            launches[name], paths[name] = counts[name], "gliclass-base int8-dynamic classify_job, attn_route=tiled"
        launches_tc["tiled_attention"] = counts["tiled_attention_tc"]
        if "flash_disentangled_attention" not in launches:  # "auto" took no K1 on the main path
            launches["flash_disentangled_attention"] = counts["flash_disentangled_attention"]
            launches_tc["flash_disentangled_attention"] = counts["flash_disentangled_attention_tc"]
            paths["flash_disentangled_attention"] = ("gliclass-base int8-dynamic classify_job, attn_route=tiled "
                                                     "(the buckets that are not multiples of 32)")
        torch.cuda.empty_cache()

    with phase("phase 7: serve path, GLiClassServer over the bias route"):
        counts, n_fwd = serve_path(cfg, qparams, tok, np.random.default_rng([args.seed, 8]), dev)
        for name in ("abs_pos_table", "bias_fused_attention"):
            launches[name], paths[name] = counts[name], "serve: gliclass-base int8-dynamic, attn_route=bias"
        launches_tc["bias_fused_attention"] = counts["bias_fused_attention_tc"]
    del qparams
    torch.cuda.empty_cache()

    with phase("phase 8: gliclass-qwen-1.5B int8-dynamic"):
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
        counts, shapes = run_path(cfg, qparams, tok, job, "int8-dynamic", dev, 4,
                                  "qwen-1.5B int8-dynamic", batch_size=64, hidden_tol=0.15, profile=True)
        n_fwd = len(shapes)
        expect_launches(counts, "causal_flash_attention", bb.num_hidden_layers * n_fwd, "qwen path")
        # d = 128 in bf16: every K5 launch on tensor cores.
        expect_launches(counts, "causal_flash_attention_tc", counts["causal_flash_attention"], "qwen path")
        launches["causal_flash_attention"] = counts["causal_flash_attention"]
        launches_tc["causal_flash_attention"] = counts["causal_flash_attention_tc"]
        paths["causal_flash_attention"] = "gliclass-qwen-1.5B int8-dynamic"
        del qparams
        torch.cuda.empty_cache()

    with phase("phase 9: llama-1.3B geometry, 4 of 24 layers, int8-dynamic"):
        bb = dataclasses.replace(llama_config("1.3b"), num_hidden_layers=4)
        tok = PromptTokenizer(WordTokenizer(bb.vocab_size))
        cfg = GLiClassConfig(hidden_size=bb.hidden_size, class_token_index=tok.label_token_id,
                             text_token_index=tok.sep_token_id, prompt_first=False, backbone=bb)
        rng = np.random.default_rng([args.seed, 6])
        qparams = make_decoder_params(rng, bb, cfg.hidden_size)
        job = make_job(rng, 64, 16)
        counts, shapes = run_path(cfg, qparams, tok, job, "int8-dynamic", dev, 4,
                                  "llama-1.3B (4 of 24 layers) int8-dynamic", batch_size=64)
        n_fwd = len(shapes)
        expect_launches(counts, "causal_flash_attention", bb.num_hidden_layers * n_fwd, "llama path")
        expect_launches(counts, "causal_flash_attention_tc", counts["causal_flash_attention"], "llama path")
        del qparams

    sources = {
        "flash_disentangled_attention": ("gliclass/c_tpu_torch/csrc/flash_disentangled_attention_tc.cu",
                                         "gliclass/c_tpu/ops/fused_attention.py:275"),
        "fused_ffn_w8a8": ("gliclass/c_tpu_torch/csrc/fused_ffn_w8a8_tc.cu", "gliclass/c_tpu/ops/fused_ffn.py:78"),
        "int8_matmul": ("gliclass/c_tpu_torch/csrc/int8_matmul_tc.cu", "gliclass/c_tpu/ops/int8_matmul.py:35"),
        "fused_ffn_wonly": ("gliclass/c_tpu_torch/csrc/fused_ffn_wonly_tc.cu", "gliclass/c_tpu/ops/fused_ffn.py:91"),
        "causal_flash_attention": ("gliclass/c_tpu_torch/csrc/causal_flash_attention_tc.cu",
                                   "gliclass/c_tpu/ops/causal_attention.py:116"),
        "abs_pos_table": ("gliclass/c_tpu_torch/csrc/abs_pos_table.cu", "gliclass/c_tpu/ops/fused_attention.py:470"),
        "bias_fused_attention": ("gliclass/c_tpu_torch/csrc/bias_fused_attention_tc.cu",
                                 "gliclass/c_tpu/ops/fused_attention.py:547"),
        "row_disentangled_attention": ("gliclass/c_tpu_torch/csrc/row_disentangled_attention_tc.cu",
                                       "gliclass/c_tpu/ops/fused_attention.py:91"),
        "windowed_pos_tables": ("gliclass/c_tpu_torch/csrc/windowed_pos_table.cu",
                                "gliclass/c_tpu/ops/fused_attention.py:743"),
        "tiled_attention": ("gliclass/c_tpu_torch/csrc/tiled_disentangled_attention_tc.cu",
                            "gliclass/c_tpu/ops/fused_attention.py:810"),
    }
    kernels = []
    for name, r in rec.items():
        if launches[name] <= 0:
            fail(f"{name} was launched no time on its path ({paths[name]})")
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name][0], "replaces": sources[name][1],
            "launches": launches[name], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r.get("library_ms"), "shape": r["shape"], "path": paths[name],
        })
        if "variant" in r:  # K1, K2, K3, K4, K5, K7, K8 and K10: the tensor-core variant's record
            kernels[-1].update(variant=r["variant"], launches_tc=launches_tc[name],
                               cuda_core_ms=r["cuda_core_ms"])
        # K2, K4, K5, K6 and K9: beside ms (through the wrapper), the C
        # entry's time with its arguments built once and the profiler's
        # device time; K5 also SDPA's device time; K6 the same times at the
        # short buckets.
        kernels[-1].update({key: r[key] for key in ("entry_ms", "device_ms", "library_device_ms", "by_shape")
                            if key in r})
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
