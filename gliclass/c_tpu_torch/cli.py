"""CLI driver of the port: the reference binary's contract plus serve/selftest.

    python -m gliclass.c_tpu_torch.cli run data.json [prompt_first] --bundle BUNDLE [options]
    python -m gliclass.c_tpu_torch.cli serve --bundle BUNDLE [--warmup] [options]
    python -m gliclass.c_tpu_torch.cli selftest --bundle BUNDLE [options]
    python -m gliclass.c_tpu_torch.cli convert --model-path DIR --save-path BUNDLE [--quantize]

Flags and output follow ``gliclass.c_tpu.cli``: ``run`` prints the
reference report, ``Execution time: %f seconds`` (reference main.c:171) and a
throughput line; ``selftest`` gates the bundle's golden logits and, with
INT8, the micro-F1 delta. The DeBERTa attention route comes from
GLICLASS_TPU_ATTN_ROUTE, the variable the JAX package reads, so one setting
switches both:

    auto   the route measured fastest on the H100 at each forward's shape
    flash  K1 (online softmax, c2p/p2c formed per tile) at every length
    bias   K6 tables, bias products and K7 at 8-aligned lengths up to 2048
    row    K8 (whole score rows on chip) at 8-aligned lengths up to 512
    tiled  K9 windowed tables and K10 at lengths that are multiples of 32
    table, xla  the materialized-score path (no attention kernel)

bias, row and tiled run K1 at the lengths their kernels do not take; on the
card a head width other than 64 takes the score path under every route.

``convert`` turns a local HF gliclass checkpoint directory into a bundle on
the host (it builds the torch reference model through ``transformers`` for
the goldens). ``fetch`` and ``--model`` download from the hub and stay with
the JAX package's CLI. Each fails with a message saying so.

``run``, ``selftest`` and ``serve`` take ``--dp/--sp/--tp`` over ranks
launched with the JAX package's variables or torchrun's (``parallel.
distributed.initialize_from_env``, called at entry). Under ``run`` and
``selftest`` every rank runs the command in step, and global rank 0 prints.
Under ``serve`` global rank 0 leads: it serves HTTP and broadcasts each
forward's inputs, the other ranks follow, and every rank exits 0 when the
leader stops (SIGTERM). Sizes other than 1 without such a launch are
refused. Commands run on the CUDA card; ``main(argv, device="cpu")`` runs
them on the CPU (the tests do).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import signal
import sys
import threading
import time

from .config import RuntimeConfig
from .data import load_job, string_to_bool


def _runtime_from_args(args) -> RuntimeConfig:
    import torch.distributed as dist

    from .parallel.distributed import LAUNCHER_VARS

    n = args.dp * args.sp * args.tp
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n != world:
        how = (f"launch {n} processes with {LAUNCHER_VARS} set" if world == 1
               else f"the launch has {world} ranks")
        raise SystemExit(f"error: --dp {args.dp} --sp {args.sp} --tp {args.tp} needs {n} ranks: {how}")
    return RuntimeConfig(
        batch_size=args.batch_size,
        max_length=args.max_length,
        threshold=args.threshold,
        compute_dtype=args.dtype,
        quant_mode="int8-dynamic" if args.int8_dynamic else ("int8" if args.int8 else "none"),
        tokenizer_workers=args.workers,
        attn_route=os.environ.get("GLICLASS_TPU_ATTN_ROUTE", "auto"),
        dp_size=args.dp,
        sp_size=args.sp,
        tp_size=args.tp,
    )


def _resolve_bundle(args) -> str:
    if args.bundle:
        return args.bundle
    if args.model:
        raise SystemExit(
            "error: --model downloads a checkpoint from the hub, which the port does not do; "
            "download it, convert it with `convert --model-path DIR --save-path BUNDLE` "
            "and pass --bundle BUNDLE"
        )
    raise SystemExit("error: pass --bundle PATH or --model HF_NAME")


def _add_runtime_flags(p: argparse.ArgumentParser):
    p.add_argument("--bundle", default=None, help="path to a converted weight bundle")
    p.add_argument("--model", default=None,
                   help="HF model name (downloads; refused by the port, use --bundle)")
    p.add_argument("--batch-size", type=int, default=8)  # configs.h:4 default
    p.add_argument("--max-length", type=int, default=2048)  # configs.h:5 default
    p.add_argument("--threshold", type=float, default=0.5)  # configs.h:6 default
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument("--int8", action="store_true", help="use the INT8 weight bundle")
    p.add_argument("--int8-dynamic", action="store_true",
                   help="w8a8: INT8 weight bundle + dynamic per-token INT8 activations "
                   "(the reference's ONNX dynamic-quantization mode)")
    p.add_argument("--dp", type=int, default=1, help="data-parallel mesh size (dp x sp x tp launched ranks)")
    p.add_argument("--tp", type=int, default=1, help="tensor-parallel mesh size (dp x sp x tp launched ranks)")
    p.add_argument("--sp", type=int, default=1, help="sequence-parallel mesh size (dp x sp x tp launched ranks)")
    p.add_argument("--workers", type=int, default=8, help="tokenizer worker processes for large jobs")


def cmd_run(args, device=None) -> int:
    from .pipeline import ZeroShotClassificationPipeline

    job = load_job(args.data)
    prompt_first = string_to_bool(args.prompt_first) if args.prompt_first is not None else None
    runtime = _runtime_from_args(args)
    pipe = ZeroShotClassificationPipeline.from_bundle(
        _resolve_bundle(args), runtime, device=device, prompt_first=prompt_first
    )
    start = time.perf_counter()
    out = pipe.classify_job(job)
    elapsed = time.perf_counter() - start

    sys.stdout.write(out.report)
    print(f"Execution time: {elapsed:f} seconds")  # reference main.c:171
    print(f"Throughput: {job.num_texts / elapsed:.1f} texts/s")
    if args.verbose and out.timings:
        print(f"Stages: {json.dumps(out.timings)}", file=sys.stderr)
    if args.json_out and _rank() == 0:
        with open(args.json_out, "w") as f:
            json.dump(out.to_json(), f, indent=2)
        print(f"Results written to {args.json_out}")
    if out.failures:
        # Each failed batch was retried once; report the residue and exit
        # non-zero with the partial report intact.
        for f in out.failures:
            print(f"error: batch of {len(f.indices)} text(s) failed after retry: {f.error}",
                  file=sys.stderr)
        print(f"{len(out.failed_indices)}/{job.num_texts} texts FAILED (see stderr); "
              "remaining results are valid", file=sys.stderr)
        return 1
    return 0


def cmd_convert(args, device=None) -> int:
    """Convert a local HF gliclass checkpoint directory into a weight bundle
    (on the host: ``device`` is not used). Expects model.safetensors (or
    pytorch_model.bin), config.json and tokenizer.json in --model-path."""
    from .convert.convert import convert_checkpoint_dir

    try:
        convert_checkpoint_dir(args.model_path, args.save_path, args.model_path, quantize=args.quantize)
    except FileNotFoundError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    print(f"DONE: bundle written to {args.save_path}")
    return 0


def cmd_fetch(args, device=None) -> int:
    print("error: `fetch` downloads a checkpoint from the hub, which the port does not do; "
          "download it, then run `convert --model-path DIR --save-path BUNDLE`", file=sys.stderr)
    return 2


def cmd_serve(args, device=None) -> int:
    """Serve the model over HTTP with continuous batching. Over a multi-rank
    mesh global rank 0 leads (the scheduler, the HTTP server, and a
    broadcast of each forward's inputs) and every other rank follows
    (``InferenceEngine.follow``) until the leader stops them: on SIGTERM,
    or when its server closes."""
    from .convert import bundle as B
    from .engine import InferenceEngine

    runtime = _runtime_from_args(args)
    bundle_path = _resolve_bundle(args)
    engine = InferenceEngine.from_bundle(bundle_path, runtime, device)
    if _rank() != 0:
        return engine.follow()
    engine.lead()
    try:
        return _lead_serve(args, engine, runtime, B.tokenizer_path(bundle_path))
    finally:
        engine.stop_followers()


def _lead_serve(args, engine, runtime, tokenizer_path) -> int:
    from .serving import GLiClassServer
    from .tokenization import PromptTokenizer

    tokenizer = PromptTokenizer.from_file(tokenizer_path)
    if args.warmup:
        # Every (seq, row, label) bucket once before binding the port, on the
        # route each bucket takes, so early traffic pays no first-use costs.
        n = engine.warmup(max_seq=args.warmup_max_seq, log=lambda m: print(f"[serve] {m}", flush=True))
        print(f"[serve] warmed {n} steps", flush=True)
    server = GLiClassServer(
        engine, tokenizer, runtime, host=args.host, port=args.port,
        max_wait_ms=args.max_wait_ms, max_pending=args.max_pending,
        result_timeout_s=args.result_timeout_s, pipeline_depth=args.pipeline_depth,
        round_requests=args.round_requests,
    )
    print(f"serving {engine.cfg.original_model_name} on http://{args.host}:{server.port} "
          "(POST /classify)", flush=True)
    # Graceful SIGTERM: stop accepting, fail queued requests fast, exit 0.
    # shutdown() must run on another thread: called from the handler (the
    # main thread, inside serve_forever) it would wait on its own loop.
    previous = signal.signal(
        signal.SIGTERM,
        lambda *_: threading.Thread(target=server.httpd.shutdown, daemon=True).start(),
    )
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.close()
        signal.signal(signal.SIGTERM, previous)
    return 0


def cmd_selftest(args, device=None) -> int:
    """Golden-logit regression: re-run the bundle's golden samples through
    the port and hold them to the recorded logits; with INT8, also the
    micro-F1 gate against the fp32 path."""
    from .convert import bundle as B
    from .pipeline import ZeroShotClassificationPipeline
    from .utils.eval import golden_logit_check, int8_f1_gate

    runtime = _runtime_from_args(args)
    bundle_path = _resolve_bundle(args)
    pipe = ZeroShotClassificationPipeline.from_bundle(bundle_path, runtime, device=device)
    goldens = B.load_goldens(bundle_path)
    if not goldens:
        print("no goldens.json in bundle; nothing to check", file=sys.stderr)
        return 1
    worst = golden_logit_check(pipe, goldens, runtime)
    any_int8 = args.int8 or args.int8_dynamic
    # The JAX package's tolerances (gliclass/c_tpu/cli.py): fp32 1e-3 (the
    # reference's gate); INT8 or bf16 derived from measured logit deltas,
    # 0.15 for the 12-layer encoder, 0.71 for the 28-layer decoders.
    if runtime.compute_dtype == "float32" and not any_int8:
        tol = 1e-3
    elif pipe.engine.cfg.backbone.model_type in ("llama", "qwen2"):
        tol = 0.71
    else:
        tol = 0.15
    status = "PASS" if worst <= tol else "FAIL"
    print(f"golden-logit check: max |delta| = {worst:.6f} (tol {tol}) {status}")
    rc = 0 if status == "PASS" else 1

    if any_int8:
        # Micro-F1 delta of the INT8 path against the fp32 path of the same
        # bundle, over the deterministic synthetic eval set: within 0.5%.
        rt32 = dataclasses.replace(runtime, quant_mode="none")
        pipe32 = ZeroShotClassificationPipeline.from_bundle(bundle_path, rt32, device=device)
        gate = int8_f1_gate(pipe32, pipe, n_texts=256, threshold=runtime.threshold)
        f1_ok = gate["delta"] <= 0.005
        print(
            f"int8 F1 gate: fp32={gate['f1_fp32']:.4f} int8={gate['f1_int8']:.4f} "
            f"delta={gate['delta']:.4f} (tol 0.005) "
            f"max|prob delta|={gate['max_prob_delta']:.2e} " + ("PASS" if f1_ok else "FAIL")
        )
        if not f1_ok:
            rc = 1
    return rc


def main(argv=None, device=None) -> int:
    """Run one command. ``device``: None for the CUDA card (raise without
    one), or a torch device such as "cpu"."""
    parser = argparse.ArgumentParser(
        prog="python -m gliclass.c_tpu_torch.cli",
        description="GLiClass zero-shot classification on an NVIDIA GPU (PyTorch port)",
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    p_run = sub.add_parser("run", help="classify a JSON job file")
    p_run.add_argument("data", help="path to the job JSON (reference schema)")
    p_run.add_argument("prompt_first", nargs="?", default=None,
                       help="true/false override; defaults to the bundle config")
    p_run.add_argument("--json-out", default=None, help="write structured results here")
    p_run.add_argument("--verbose", action="store_true", help="print stage timings")
    _add_runtime_flags(p_run)
    p_run.set_defaults(fn=cmd_run)

    p_conv = sub.add_parser("convert", help="convert a local HF gliclass checkpoint directory to a bundle")
    p_conv.add_argument("--model-path", required=True, help="checkpoint dir (config, tokenizer, weights)")
    p_conv.add_argument("--save-path", required=True, help="bundle directory to write")
    p_conv.add_argument("--quantize", action="store_true", help="also write the INT8 weights")
    p_conv.set_defaults(fn=cmd_convert)
    # The JAX CLI's flags, so that its command lines fail with the reason.
    p_fetch = sub.add_parser("fetch", help="download an HF model (refused: the port does not download)")
    p_fetch.add_argument("model_name")
    p_fetch.add_argument("--no-quantize", action="store_true")
    p_fetch.add_argument("--force", action="store_true")
    p_fetch.set_defaults(fn=cmd_fetch)

    p_serve = sub.add_parser("serve", help="HTTP serving with continuous batching")
    p_serve.add_argument("--host", default="127.0.0.1",
                         help="bind address; use 0.0.0.0 (behind a proxy) to expose externally")
    p_serve.add_argument("--port", type=int, default=8000)
    p_serve.add_argument("--max-wait-ms", type=float, default=5.0,
                         help="micro-batch fill window before dispatching a partial batch")
    p_serve.add_argument("--max-pending", type=int, default=4096,
                         help="bounded request queue depth; beyond it requests get HTTP 429")
    p_serve.add_argument("--result-timeout-s", type=float, default=120.0,
                         help="per-request wait on the scheduler before a 500")
    p_serve.add_argument("--pipeline-depth", type=int, default=4,
                         help="scheduler rounds in flight (tokenize/dispatch/drain pipeline)")
    p_serve.add_argument("--round-requests", type=int, default=None,
                         help="requests per scheduler round (default 8x batch size)")
    p_serve.add_argument("--warmup", action="store_true",
                         help="run every serving step once before accepting traffic")
    p_serve.add_argument("--warmup-max-seq", type=int, default=None,
                         help="skip warmup of seq buckets above this")
    _add_runtime_flags(p_serve)
    p_serve.set_defaults(fn=cmd_serve)

    p_self = sub.add_parser("selftest", help="golden-logit regression check")
    _add_runtime_flags(p_self)
    p_self.set_defaults(fn=cmd_selftest)

    args = parser.parse_args(argv)
    if args.fn not in (cmd_run, cmd_selftest, cmd_serve):
        return args.fn(args, device=device)
    import torch.distributed as dist

    from .parallel.distributed import initialize_from_env

    owned = not dist.is_initialized() and initialize_from_env(device=device)
    try:
        # Every rank runs the command; global rank 0 prints.
        quiet = contextlib.redirect_stdout(io.StringIO()) if _rank() else contextlib.nullcontext()
        with quiet:
            return args.fn(args, device=device)
    finally:
        if owned:
            dist.destroy_process_group()


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


if __name__ == "__main__":
    sys.exit(main())
