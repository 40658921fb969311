"""The port's bundle reader, scheduler and pipeline vs the JAX package, on CPU,
and the port's import boundary (no JAX, nothing of gliclass.c_tpu)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from gliclass.c_tpu.config import BackboneConfig as JBackbone
from gliclass.c_tpu.config import GLiClassConfig as JConfig
from gliclass.c_tpu.config import RuntimeConfig as JRuntime
from gliclass.c_tpu.data import parse_job as j_parse_job
from gliclass.c_tpu.parallel.scheduler import plan_batches as j_plan_batches
from gliclass.c_tpu.pipeline import ZeroShotClassificationPipeline as JPipeline
from gliclass.c_tpu.prompting import pack_prompts as j_pack_prompts
from gliclass.c_tpu.tokenization import PromptTokenizer as JTokenizer
from gliclass.c_tpu_torch.config import RuntimeConfig
from gliclass.c_tpu_torch.convert import bundle as tbundle
from gliclass.c_tpu_torch.data import parse_job
from gliclass.c_tpu_torch.engine import InferenceEngine
from gliclass.c_tpu_torch.parallel.scheduler import plan_batches, run_planned
from gliclass.c_tpu_torch.pipeline import ZeroShotClassificationPipeline
from gliclass.c_tpu_torch.prompting import pack_prompt, pack_prompts
from gliclass.c_tpu_torch.tokenization import PromptTokenizer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RT = dict(batch_size=4, max_length=64, compute_dtype="float32",
          seq_buckets=(16, 32, 64), label_buckets=(2, 4, 8))

JOBS = [
    {
        "texts": ["the quick brown fox jumps over the lazy dog",
                  "onnx is an open-source format for ai models",
                  "why are you running", "support ukraine", "science business sports",
                  "the lazy dog"],
        "labels": [["science", "sports", "format", "question"]],
        "same_labels": True,
        "classification_type": "multi-label",
    },
    {
        "texts": ["the quick brown fox", "why are you running", "support ukraine"],
        "labels": [["science", "sports"], ["question", "statement", "animal"], ["call to action"]],
        "same_labels": False,
        "classification_type": "single-label",
    },
]


@pytest.fixture(scope="module")
def bundle_dir(tiny_tokenizer_file, tmp_path_factory):
    """A tiny fp32 + INT8 bundle written by the JAX package's converter."""
    from gliclass.c_tpu.convert.convert import export_bundle
    from gliclass.c_tpu.convert.torch_ref import build_torch_gliclass

    tok = JTokenizer.from_file(tiny_tokenizer_file)
    bb = JBackbone(model_type="deberta-v2", vocab_size=600, hidden_size=32,
                   num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
                   max_position_embeddings=64, position_buckets=16,
                   norm_rel_ebd="layer_norm", share_att_key=True, position_biased_input=False)
    cfg = JConfig(hidden_size=32, class_token_index=tok.label_token_id,
                  text_token_index=tok.sep_token_id, prompt_first=True, backbone=bb)
    path = str(tmp_path_factory.mktemp("bundle") / "b")
    export_bundle(build_torch_gliclass(cfg), cfg, tok, path, quantize=True)
    return path


@pytest.mark.parametrize("name", ["weights.safetensors", "weights_int8.safetensors"])
def test_bundle_reader_bit_equal_to_safetensors(bundle_dir, name):
    from safetensors.numpy import load_file

    want = load_file(os.path.join(bundle_dir, name))
    got = tbundle.read_safetensors(os.path.join(bundle_dir, name))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k


def test_bundle_config_and_goldens(bundle_dir):
    from gliclass.c_tpu.convert import bundle as jbundle

    assert json.loads(tbundle.load_config(bundle_dir).to_json()) == json.loads(
        jbundle.load_config(bundle_dir).to_json()
    )
    assert tbundle.load_goldens(bundle_dir) == jbundle.load_goldens(bundle_dir)
    q = tbundle.load_params(bundle_dir, quantized=True)
    assert q["backbone"]["layers"]["attn"]["q"]["w_q"].dtype == np.int8


@pytest.mark.parametrize("quant_mode", ["none", "int8"])
@pytest.mark.parametrize("job_i", [0, 1])
def test_classify_job_matches_jax_pipeline(bundle_dir, quant_mode, job_i):
    """classify_job of the port and of the JAX package on one fp32 bundle:
    the same JSON (decisions exactly, scores to 1e-5, since two
    implementations round fp32 differently) and, with fp32 weights, the same
    report text (scores printed to 6 decimals). INT8 weight-only scales the
    accumulator where JAX scales the weight, which can move the 6th decimal."""
    jpipe = JPipeline.from_bundle(bundle_dir, JRuntime(quant_mode=quant_mode, **RT))
    tpipe = ZeroShotClassificationPipeline.from_bundle(
        bundle_dir, RuntimeConfig(quant_mode=quant_mode, **RT), device="cpu"
    )
    jout = jpipe.classify_job(j_parse_job(JOBS[job_i]))
    tout = tpipe.classify_job(parse_job(JOBS[job_i]))
    assert tout.failures == [] and jout.failures == []
    np.testing.assert_allclose(tout.probs, jout.probs, atol=1e-5, rtol=1e-5)
    if quant_mode == "none":
        assert tout.report == jout.report
    tj, jj = tout.to_json(), jout.to_json()
    assert len(tj) == len(jj)
    for a, b in zip(tj, jj):
        assert (a["text_index"], a["text"]) == (b["text_index"], b["text"])
        assert [(d["label"], d["index"]) for d in a["decisions"]] == [
            (d["label"], d["index"]) for d in b["decisions"]
        ]
        np.testing.assert_allclose([d["score"] for d in a["decisions"]],
                                   [d["score"] for d in b["decisions"]], atol=1e-5)


def test_golden_logits_of_bundle(bundle_dir):
    """The bundle's golden logits (fp32 torch reference) through the port's
    fp32 forward, at the reference's gate of 1e-3."""
    import torch

    from gliclass.c_tpu_torch.convert.params import params_from_numpy
    from gliclass.c_tpu_torch.models.gliclass import gliclass_forward

    cfg = tbundle.load_config(bundle_dir)
    params = params_from_numpy(tbundle.load_params(bundle_dir), "cpu")
    tok = PromptTokenizer.from_file(tbundle.tokenizer_path(bundle_dir))
    for rec in tbundle.load_goldens(bundle_dir):
        prompts = pack_prompts(rec["texts"], rec["labels"], rec["same_labels"], rec["prompt_first"])
        b = tok.encode_batch(prompts, max_length=rec["max_length"])
        n = max(len(l) for l in rec["labels"])
        got = gliclass_forward(params, torch.from_numpy(b.input_ids), torch.from_numpy(b.attention_mask),
                               cfg, n).numpy()
        np.testing.assert_allclose(got, np.asarray(rec["logits"]), atol=1e-3)


@pytest.fixture(scope="module")
def engine(bundle_dir):
    return InferenceEngine.from_bundle(bundle_dir, RuntimeConfig(**RT), device="cpu")


def test_plan_batches_matches_jax(bundle_dir, engine):
    tok = PromptTokenizer.from_file(tbundle.tokenizer_path(bundle_dir))
    jtok = JTokenizer.from_file(tbundle.tokenizer_path(bundle_dir))
    texts = ["short", "the quick brown fox jumps over the lazy dog " * 2] * 5
    labels = [["a", "b"], ["c", "d", "e", "f", "g"]] * 5
    prompts = [pack_prompt(t, l, True) for t, l in zip(texts, labels)]
    assert prompts == j_pack_prompts(texts, labels, False, True)
    counts = [len(l) for l in labels]
    got = plan_batches(tok, prompts, counts, RuntimeConfig(**RT))
    want = j_plan_batches(jtok, prompts, counts, JRuntime(**RT))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.indices == b.indices and a.max_labels == b.max_labels
        np.testing.assert_array_equal(a.batch.input_ids, b.batch.input_ids)
        np.testing.assert_array_equal(a.batch.attention_mask, b.batch.attention_mask)


class _FaultyEngine:
    """Wraps the engine; fails dispatch of the given seq bucket ``fail_times``
    times (a transient or persistent device fault)."""

    def __init__(self, engine, fail_seq, fail_times):
        self._engine, self.fail_seq, self.remaining = engine, fail_seq, fail_times
        self.cfg, self.runtime, self.mesh = engine.cfg, engine.runtime, engine.mesh

    def _maybe_fail(self, seq):
        if seq == self.fail_seq and self.remaining > 0:
            self.remaining -= 1
            raise RuntimeError("injected device fault")

    def run_async(self, batch, max_labels):
        self._maybe_fail(batch.seq_length)
        return self._engine.run_async(batch, max_labels)

    def stack_batches(self, batches):
        return self._engine.stack_batches(batches)

    def run_stacked_async(self, ids, mask, max_labels):
        self._maybe_fail(ids.shape[2])
        return self._engine.run_stacked_async(ids, mask, max_labels)

    def run(self, batch, max_labels):
        dev, n = self.run_async(batch, max_labels)
        return dev.numpy()[:n]


def _planned(bundle_dir):
    tok = PromptTokenizer.from_file(tbundle.tokenizer_path(bundle_dir))
    texts = ["short", "the quick brown fox jumps over the lazy dog " * 2] * 5
    labels = [["a", "b"], ["c", "d", "e", "f", "g"]] * 5
    prompts = [pack_prompt(t, l, True) for t, l in zip(texts, labels)]
    return plan_batches(tok, prompts, [len(l) for l in labels], RuntimeConfig(**RT))


def test_run_planned_matches_direct_run(bundle_dir, engine):
    planned = _planned(bundle_dir)
    probs = run_planned(engine, planned, 10, 5)
    for pb in planned:
        np.testing.assert_allclose(probs[pb.indices, : pb.max_labels][:, :5],
                                   engine.run(pb.batch, pb.max_labels)[:, :5], atol=1e-6)


@pytest.mark.parametrize("fail_times", [1, 10**9])
def test_retry_then_isolate(bundle_dir, engine, fail_times):
    """A transient fault costs one retry and nothing else; a persistent one
    fails only its batch's texts, recorded as BatchFailure."""
    planned = _planned(bundle_dir)
    ref = run_planned(engine, planned, 10, 5)
    fail_seq = planned[0].batch.seq_length
    failures = []
    probs = run_planned(_FaultyEngine(engine, fail_seq, fail_times), planned, 10, 5, failures=failures)
    failed = {i for f in failures for i in f.indices}
    expected = set() if fail_times == 1 else {
        i for pb in planned if pb.batch.seq_length == fail_seq for i in pb.indices
    }
    assert failed == expected
    ok = sorted(set(range(10)) - failed)
    np.testing.assert_allclose(probs[ok], ref[ok], atol=1e-6)
    if failed:
        assert probs[sorted(failed)].max() == 0.0
        assert all("injected device fault" in f.error and "retry" in f.error for f in failures)
        with pytest.raises(RuntimeError, match="injected device fault"):
            run_planned(_FaultyEngine(engine, fail_seq, fail_times), planned, 10, 5)


@pytest.mark.parametrize("overlap", ["auto", "off"])
def test_pipeline_call_api(bundle_dir, engine, overlap):
    """__call__ with a shared label list, streamed (affix encoder) and
    barrier plans, gives the same probabilities."""
    tok = PromptTokenizer.from_file(tbundle.tokenizer_path(bundle_dir))
    rt = RuntimeConfig(overlap_tokenize=overlap, **RT)
    pipe = ZeroShotClassificationPipeline(engine, tok, rt)
    texts = ["the quick brown fox", "why are you running", "support ukraine"]
    results = pipe(texts, ["science", "sports"], classification_type="single-label")
    assert [len(r.decisions) for r in results] == [1, 1, 1]
    assert all(r.decisions[0].label in ("science", "sports") for r in results)
    ref = ZeroShotClassificationPipeline(engine, tok, RuntimeConfig(overlap_tokenize="off", **RT))
    np.testing.assert_allclose(pipe.predict_probs(texts, [["science", "sports"]], True),
                               ref.predict_probs(texts, [["science", "sports"]], True), atol=1e-6)


# ---------------------------------------------------------------------------
# The tokenizer's worker pool on the batch plane
WORDS = ("the quick brown fox jumps over a lazy dog while science and sports news "
         "run through onnx models café ﬁne why are you running").split()


def _job(n: int, same_labels: bool, bad: int | None = None) -> dict:
    texts = [" ".join(WORDS[(i * 7 + k) % len(WORDS)] for k in range(2 + i % 11)) for i in range(n)]
    if bad is not None:
        texts[bad] = 5  # not a str: the encode raises
    pool = ["science", "sports", "format", "question", "animal", "travel", "news"]
    labels = [pool[:4]] if same_labels else [pool[: 1 + i % len(pool)] for i in range(n)]
    return {"texts": texts, "labels": labels, "same_labels": same_labels,
            "classification_type": "multi-label"}


# Batches of 64 rows keep a 300-text job to a few forwards.
POOL_RT = dict(RT, batch_size=64, tokenizer_workers=2)


@pytest.fixture(scope="module")
def pooled_pipe(bundle_dir):
    """The tiny CPU engine behind a tokenizer that pools two workers."""
    pipe = ZeroShotClassificationPipeline.from_bundle(bundle_dir, RuntimeConfig(**POOL_RT), device="cpu")
    yield pipe
    if pipe.tokenizer._pool is not None:
        pipe.tokenizer._pool.close()


def _in_thread(monkeypatch):
    from gliclass.c_tpu_torch import tokenization
    from gliclass.c_tpu_torch.parallel import scheduler

    for mod in (scheduler, tokenization):
        monkeypatch.setattr(mod, "POOL_MIN_TEXTS", 10**9)


@pytest.mark.parametrize("case", ["shared labels", "per-text labels", "barrier plan"])
def test_pooled_job_bit_equal_to_in_thread(pooled_pipe, case, monkeypatch):
    """A job of 300 texts: the same probabilities, bit for bit, whether its
    chunks are encoded in the pool or in the producer thread (the composed
    AffixEncoder path, packed prompts, and the barrier plan's
    ``encode_batch_parallel``); the job's timings count the chunks of each
    kind, and with the recorder on each pooled ``tokenize`` span carries
    ``pooled`` and the worker's ms."""
    from gliclass.c_tpu_torch.utils import metrics

    pipe = pooled_pipe
    if case == "barrier plan":
        pipe = ZeroShotClassificationPipeline(pipe.engine, pipe.tokenizer,
                                              RuntimeConfig(overlap_tokenize="off", **POOL_RT))
    job = parse_job(_job(300, case == "shared labels"))
    runs = {}
    for way in ("pooled", "inline"):
        if way == "inline":
            _in_thread(monkeypatch)
        rec = metrics.start()
        try:
            runs[way] = pipe.classify_job(job)
        finally:
            metrics.stop()
        runs[way + " spans"] = [s for s in rec.spans if s.name == "tokenize"]
    assert pipe.tokenizer._pool is not None and runs["pooled"].failures == []
    assert np.array_equal(runs["pooled"].probs, runs["inline"].probs)
    if case != "barrier plan":
        assert runs["pooled"].timings["tokenize_chunks_pooled"] > 0
        assert runs["inline"].timings["tokenize_chunks_inline"] > 0
        assert "tokenize_chunks_inline" not in runs["pooled"].timings
        assert "tokenize_chunks_pooled" not in runs["inline"].timings
        pooled, inline = runs["pooled spans"], runs["inline spans"]
        assert all(s.attrs["pooled"] == 1 and s.attrs["worker_ms"] > 0 for s in pooled)
        assert not any("pooled" in s.attrs for s in inline)
        for key in ("texts", "tokens"):
            assert sum(s.attrs[key] for s in pooled) == sum(s.attrs[key] for s in inline)
        assert sum(s.attrs["texts"] for s in pooled) == 300


def _fresh_pipe(pooled_pipe, bundle_dir):
    """The module's engine behind a tokenizer of its own (no pool yet)."""
    tok = PromptTokenizer.from_file(tbundle.tokenizer_path(bundle_dir))
    return ZeroShotClassificationPipeline(pooled_pipe.engine, tok, RuntimeConfig(**POOL_RT))


def _children() -> set[int]:
    """This process's child processes, from every thread's ``children``."""
    tasks = f"/proc/{os.getpid()}/task"
    return {int(c) for t in os.listdir(tasks) for c in open(f"{tasks}/{t}/children").read().split()}


def test_job_under_pool_size_starts_no_process(pooled_pipe, bundle_dir):
    pipe = _fresh_pipe(pooled_pipe, bundle_dir)
    before = _children()
    out = pipe.classify_job(parse_job(_job(255, True)))
    assert out.timings["tokenize_chunks_inline"] > 0 and "tokenize_chunks_pooled" not in out.timings
    assert pipe.tokenizer._pool is None
    assert _children() == before


@pytest.mark.parametrize("way", ["pooled", "inline"])
def test_encode_error_reaches_the_job(pooled_pipe, way, monkeypatch):
    """An encode that raises (a text that is not a str, which
    ``parse_job`` would refuse) fails the job with its own exception, from a
    worker as from the producer thread."""
    if way == "inline":
        _in_thread(monkeypatch)
    job = _job(300, True, bad=290)
    with pytest.raises(TypeError) as err:
        pooled_pipe.predict_probs(job["texts"], job["labels"], True)
    with pytest.raises(type(err.value), match=str(err.value)):
        pooled_pipe.tokenizer.encode_batch([5], 64)


def test_killed_worker_fails_the_job_naming_the_pool(pooled_pipe, bundle_dir):
    """A worker killed between jobs: the next job fails whole with an error
    that names the pool; the job after it gets a new pool."""
    import signal

    from gliclass.c_tpu_torch.tokenize_pool import TokenizerPoolBroken

    pipe = _fresh_pipe(pooled_pipe, bundle_dir)
    pool = pipe.tokenizer.pool(2)
    futures = [pool.submit(pipe.tokenizer.task(["the quick brown fox"] * 4, 64)) for _ in range(4)]
    assert all(pool.result(f)[0].batch_size == 4 for f in futures)
    victim = pool._procs[0]
    os.kill(victim.pid, signal.SIGKILL)
    victim.wait(timeout=30)
    job = parse_job(_job(300, True))
    with pytest.raises(TokenizerPoolBroken, match=r"tokenizer worker pool \(2 processes\) broke"):
        pipe.classify_job(job)
    out = pipe.classify_job(job)
    assert pipe.tokenizer._pool is not pool and out.timings["tokenize_chunks_pooled"] > 0
    assert out.failures == [] and out.probs.shape == (300, 4)
    pipe.tokenizer._pool.close()


def test_port_imports_no_jax_and_nothing_of_c_tpu():
    """Import the port and every module of it in a fresh interpreter (the
    serving slice's serving, cli and utils.eval by name, the model-production
    slice's converter, perf model and init functions by name, the
    real-scale module and the BPE trainer by name, then everything else);
    no module named jax or jax.*, tokenizers or transformers (or below
    them), and none named gliclass.c_tpu or gliclass.c_tpu.*
    (gliclass.c_tpu_torch itself shares that prefix)."""
    code = (
        "import importlib, json, pkgutil, sys\n"
        "import gliclass.c_tpu_torch.serving, gliclass.c_tpu_torch.cli, gliclass.c_tpu_torch.utils.eval\n"
        "from gliclass.c_tpu_torch.convert.convert import convert_checkpoint_dir, export_bundle\n"
        "from gliclass.c_tpu_torch.convert.torch_ref import build_torch_gliclass, golden_logits\n"
        "from gliclass.c_tpu_torch.convert.hf_backbones import convert_deberta_state_dict\n"
        "from gliclass.c_tpu_torch.convert.bundle import save_bundle, write_safetensors\n"
        "from gliclass.c_tpu_torch.utils.perf import per_kernel_report, speed_of_light, kernel_bound_ms\n"
        "from gliclass.c_tpu_torch.utils.metrics import trace\n"
        "from gliclass.c_tpu_torch.models.deberta import init_deberta_params\n"
        "from gliclass.c_tpu_torch.models.llama import init_llama_params\n"
        "from gliclass.c_tpu_torch.models.heads import init_head_params, init_lstm_params\n"
        "from gliclass.c_tpu_torch.models.gliclass import init_gliclass_params\n"
        "from gliclass.c_tpu_torch.config import suggest_seq_buckets\n"
        "from gliclass.c_tpu_torch.utils.realscale import build_realscale_tokenizer, ensure_realscale_bundle\n"
        "from gliclass.c_tpu_torch.tokenizer.trainers import BpeTrainer, train_from_iterator\n"
        "import gliclass.c_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'gliclass.c_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'tokenizers', 'transformers')\n"
        "       or k == 'gliclass.c_tpu' or k.startswith('gliclass.c_tpu.')]\n"
        "print(json.dumps([bad, sorted(k for k in sys.modules if k.startswith('gliclass.'))]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr
    bad, loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert bad == []
    for name in ("serving", "cli", "utils.eval", "parallel.scheduler", "training.train", "training.data",
                 "training.checkpoint", "convert.convert", "convert.hf_backbones", "convert.torch_ref", "utils.perf",
                 "utils.metrics", "models.deberta", "models.llama", "models.heads", "models.gliclass",
                 "utils.realscale", "tokenizer.trainers"):
        assert f"gliclass.c_tpu_torch.{name}" in loaded


def _is_jax_side(name: str) -> bool:
    return name == "jax" or name.startswith("jax.") or name == "gliclass.c_tpu" or name.startswith(
        "gliclass.c_tpu."
    )


def test_chip_smoke_imports_nothing_of_jax():
    """Every import statement of chip_smoke.py, at top level or inside a
    function (most of its imports are lazy), names neither JAX nor the JAX
    package."""
    import ast

    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
            names += [f"{node.module}.{a.name}" for a in node.names]
    assert "gliclass.c_tpu_torch.engine" in names
    assert [n for n in names if _is_jax_side(n)] == []


def test_chip_smoke_refuses_without_cuda():
    """Without a card chip_smoke.py exits non-zero before printing a result,
    having imported nothing of JAX or the JAX package."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    code = (
        "import runpy, sys\n"
        "sys.argv = ['chip_smoke.py']\n"
        "try:\n"
        "    runpy.run_path('chip_smoke.py', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    bad = [k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "           or k == 'gliclass.c_tpu' or k.startswith('gliclass.c_tpu.')]\n"
        "    print('EXIT', e.code, bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, PYTHONPATH=ROOT))
    last = out.stdout.strip().splitlines()[-1]
    assert last == "EXIT 2 []", out.stdout + out.stderr
    assert '"ok": true' not in out.stdout
