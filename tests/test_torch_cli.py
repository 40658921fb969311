"""The port's CLI against the JAX package's, on a tiny bundle, on CPU:
``run`` (report and JSON), ``selftest`` (golden gate, INT8 F1 gate),
``serve`` wiring and a graceful SIGTERM, the route variable, ``convert``
from a local checkpoint dir, and the commands the port refuses (``fetch``,
``--model``, more than one card) failing with a clear message."""

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest

from gliclass.c_tpu.cli import main as jmain
from gliclass.c_tpu.config import BackboneConfig, GLiClassConfig
from gliclass.c_tpu_torch import serving
from gliclass.c_tpu_torch.cli import main

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = ["--dtype", "float32", "--max-length", "64"]


@pytest.fixture(scope="module")
def tiny_bundle(tiny_tokenizer_file, tmp_path_factory):
    """fp32 + INT8 bundle with goldens, written by the JAX converter."""
    from gliclass.c_tpu.convert.convert import export_bundle
    from gliclass.c_tpu.convert.torch_ref import build_torch_gliclass
    from gliclass.c_tpu.tokenization import PromptTokenizer

    tok = PromptTokenizer.from_file(tiny_tokenizer_file)
    bb = BackboneConfig(model_type="deberta-v2", vocab_size=600, hidden_size=32,
                        num_hidden_layers=2, num_attention_heads=4, intermediate_size=64,
                        max_position_embeddings=64, position_buckets=16, norm_rel_ebd="layer_norm",
                        share_att_key=True, position_biased_input=False)
    cfg = GLiClassConfig(hidden_size=32, class_token_index=tok.label_token_id,
                         text_token_index=tok.sep_token_id, prompt_first=True, backbone=bb)
    path = str(tmp_path_factory.mktemp("bundle") / "tiny")
    export_bundle(build_torch_gliclass(cfg), cfg, tok, path, quantize=True)
    return path


@pytest.fixture()
def job_file(tmp_path):
    p = tmp_path / "job.json"
    p.write_text(json.dumps({
        "texts": ["the quick brown fox", "why are you running", "support ukraine"],
        "labels": [["science", "sports", "question"]],
        "same_labels": True,
        "classification_type": "multi-label",
    }))
    return str(p)


def _report(out: str) -> list[str]:
    """stdout without the lines that carry a time or a path."""
    return [l for l in out.splitlines()
            if not l.startswith(("Execution time:", "Throughput:", "Results written to"))]


@pytest.mark.parametrize("extra", [[], ["false"]])
def test_run_matches_jax_cli(tiny_bundle, job_file, tmp_path, capsys, extra):
    """The same report (timing lines aside) and JSON to 1e-5, with the
    bundle's prompt_first and with the positional override."""
    outs = {}
    for name, fn, kw in (("jax", jmain, {}), ("port", main, {"device": "cpu"})):
        js = str(tmp_path / f"{name}.json")
        rc = fn(["run", job_file, *extra, "--bundle", tiny_bundle, *FLAGS, "--json-out", js], **kw)
        text = capsys.readouterr().out
        assert rc == 0, text
        assert "Execution time:" in text and f"Results written to {js}" in text
        outs[name] = (text, json.load(open(js)))
    assert _report(outs["port"][0]) == _report(outs["jax"][0])
    tj, jj = outs["port"][1], outs["jax"][1]
    assert len(tj) == len(jj) == 3
    for a, b in zip(tj, jj):
        assert (a["text_index"], a["text"]) == (b["text_index"], b["text"])
        assert [d["label"] for d in a["decisions"]] == [d["label"] for d in b["decisions"]]
        np.testing.assert_allclose([d["score"] for d in a["decisions"]],
                                   [d["score"] for d in b["decisions"]], atol=1e-5)


def test_run_bias_route_from_environment(tiny_bundle, job_file, tmp_path, capsys, monkeypatch):
    """GLICLASS_TPU_ATTN_ROUTE, the JAX package's variable, sets the port's
    route: bias, row, tiled and the score path give the flash route's
    results; an unknown route raises."""
    results = {}
    for route in ("flash", "bias", "row", "tiled", "xla"):
        monkeypatch.setenv("GLICLASS_TPU_ATTN_ROUTE", route)
        js = str(tmp_path / f"{route}.json")
        assert main(["run", job_file, "--bundle", tiny_bundle, *FLAGS, "--json-out", js], device="cpu") == 0
        results[route] = json.load(open(js))
    capsys.readouterr()
    for route in ("bias", "row", "tiled", "xla"):
        for a, b in zip(results[route], results["flash"]):
            assert [d["label"] for d in a["decisions"]] == [d["label"] for d in b["decisions"]]
            np.testing.assert_allclose([d["score"] for d in a["decisions"]],
                                       [d["score"] for d in b["decisions"]], atol=1e-5)
    monkeypatch.setenv("GLICLASS_TPU_ATTN_ROUTE", "bogus")
    with pytest.raises(ValueError, match="unknown attention route"):
        main(["run", job_file, "--bundle", tiny_bundle, *FLAGS], device="cpu")


def test_selftest_fp32_passes(tiny_bundle, capsys):
    rc = main(["selftest", "--bundle", tiny_bundle, *FLAGS], device="cpu")
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "golden-logit check" in out and "(tol 0.001) PASS" in out


@pytest.mark.parametrize("flag", ["--int8", "--int8-dynamic"])
def test_selftest_int8_gate(tiny_bundle, capsys, flag):
    rc = main(["selftest", "--bundle", tiny_bundle, *FLAGS, flag], device="cpu")
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "(tol 0.15) PASS" in out
    gate = [l for l in out.splitlines() if l.startswith("int8 F1 gate:")]
    assert len(gate) == 1 and gate[0].endswith("PASS"), out


def test_unported_commands_fail_clearly(tiny_tokenizer_file, tiny_bundle, job_file, tmp_path, capsys):
    """`python -m gliclass.c_tpu_torch.cli convert` writes a bundle from a
    local checkpoint dir, and `selftest --dtype float32` passes on it;
    `fetch` and `--model` (they download) and --dp/--tp/--sp other than 1
    still fail with the reason."""
    import shutil

    from safetensors.torch import save_file

    from gliclass.c_tpu.convert.torch_ref import build_torch_gliclass
    from gliclass.c_tpu.tokenization import PromptTokenizer

    from test_real_checkpoint import _hf_base_config

    tok = PromptTokenizer.from_file(tiny_tokenizer_file)
    d = _hf_base_config()
    d["class_token_index"], d["text_token_index"] = tok.label_token_id, tok.sep_token_id
    model = build_torch_gliclass(GLiClassConfig.from_dict(d), seed=7)
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    (ckpt / "config.json").write_text(json.dumps(d))
    shutil.copy(tiny_tokenizer_file, ckpt / "tokenizer.json")
    save_file({f"model.{k}": v.contiguous() for k, v in model.state_dict().items()}, str(ckpt / "model.safetensors"))
    bundle = str(tmp_path / "bundle")
    out = subprocess.run([sys.executable, "-m", "gliclass.c_tpu_torch.cli", "convert", "--model-path", str(ckpt),
                          "--save-path", bundle, "--quantize"], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr
    assert f"DONE: bundle written to {bundle}" in out.stdout
    assert sorted(os.listdir(bundle)) == ["config.json", "goldens.json", "tokenizer.json", "weights.safetensors",
                                          "weights_int8.safetensors"]
    rc = main(["selftest", "--bundle", bundle, *FLAGS], device="cpu")
    assert rc == 0 and "(tol 0.001) PASS" in capsys.readouterr().out
    assert main(["convert", "--model-path", str(tmp_path / "none"), "--save-path", bundle], device="cpu") == 1
    assert "error:" in capsys.readouterr().err

    assert main(["fetch", "some/model"], device="cpu") == 2
    assert "downloads a checkpoint from the hub" in capsys.readouterr().err
    # --dp/--tp without a launch name the launcher's variables; --sp and a
    # multi-rank serve are not ported (ROADMAP.md queue 1, items 8 and 7).
    for bad in (["--dp", "2"], ["--tp", "2"]):
        with pytest.raises(SystemExit, match="needs 2 ranks: launch 2 processes with .*MASTER_ADDR/MASTER_PORT"):
            main(["run", job_file, "--bundle", tiny_bundle, *FLAGS, *bad], device="cpu")
    with pytest.raises(SystemExit, match="ROADMAP.md queue 1, item 8"):
        main(["run", job_file, "--bundle", tiny_bundle, *FLAGS, "--sp", "2"], device="cpu")
    with pytest.raises(SystemExit, match="ROADMAP.md queue 1, item 7"):
        main(["serve", "--bundle", tiny_bundle, *FLAGS, "--tp", "2"], device="cpu")
    with pytest.raises(SystemExit, match="downloads a checkpoint from the hub"):
        main(["run", job_file, "--model", "some/model", *FLAGS], device="cpu")


def test_run_tp2_two_ranks_same_report(tiny_bundle, job_file, tmp_path, capsys):
    """`run --tp 2` in two CPU processes launched with torchrun's variables
    prints, on rank 0 alone, the report of `run --tp 1`."""
    assert main(["run", job_file, "--bundle", tiny_bundle, *FLAGS], device="cpu") == 0
    want = _report(capsys.readouterr().out)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    code = ("import sys; from gliclass.c_tpu_torch.cli import main; "
            f"sys.exit(main(['run', {job_file!r}, '--bundle', {tiny_bundle!r}, *{FLAGS!r}, '--tp', '2'], "
            "device='cpu'))")
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=dict(os.environ, PYTHONPATH=ROOT, MASTER_ADDR="127.0.0.1",
                                                  MASTER_PORT=str(port), RANK=str(r), WORLD_SIZE="2"))
             for r in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [o[1][-2000:] for o in outs]
    assert _report(outs[0][0]) == want
    assert outs[1][0] == ""


def test_serve_wiring(tiny_bundle, monkeypatch):
    """`serve` builds the server from the bundle (with --warmup), binds the
    requested ephemeral port, answers a real HTTP classify, and closes when
    serve_forever returns."""
    seen = {}

    def drive_one_request(self):
        self.start()
        body = json.dumps({"texts": ["science fox runs"], "labels": ["science", "sports"],
                           "classification_type": "single-label"}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{self.port}/classify", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            seen["resp"] = json.loads(r.read())

    monkeypatch.setattr(serving.GLiClassServer, "serve_forever", drive_one_request)
    rc = main(["serve", "--bundle", tiny_bundle, "--port", "0", "--warmup", "--warmup-max-seq", "64", *FLAGS],
              device="cpu")
    assert rc == 0
    res = seen["resp"]["results"]
    assert len(res) == 1 and len(res[0]["decisions"]) == 1
    assert res[0]["decisions"][0]["label"] in ("science", "sports")


@pytest.mark.parametrize("route", ["row", "tiled"])
def test_serve_warmup_on_row_and_tiled_routes(tiny_bundle, monkeypatch, route):
    """`serve --warmup` under GLICLASS_TPU_ATTN_ROUTE=row|tiled warms every
    bucket through that route and answers as the engine does."""
    seen = {}

    def drive_one_request(self):
        seen["route"] = self.runtime.attn_route
        self.start()
        body = json.dumps({"texts": ["science fox runs"], "labels": ["science", "sports"],
                           "classification_type": "single-label"}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{self.port}/classify", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            seen["resp"] = json.loads(r.read())

    monkeypatch.setenv("GLICLASS_TPU_ATTN_ROUTE", route)
    monkeypatch.setattr(serving.GLiClassServer, "serve_forever", drive_one_request)
    rc = main(["serve", "--bundle", tiny_bundle, "--port", "0", "--warmup", "--warmup-max-seq", "64", *FLAGS],
              device="cpu")
    assert rc == 0 and seen["route"] == route
    assert {d["label"] for d in seen["resp"]["results"][0]["decisions"]} <= {"science", "sports"}


def test_serve_sigterm_graceful(tiny_bundle):
    """Repair: SIGTERM shuts the server down from a separate thread and the
    process exits 0 (shutdown() on the signal-handling main thread, inside
    serve_forever, would deadlock). Runs the real `serve` in a subprocess."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    child = (
        "import sys\n"
        "from gliclass.c_tpu_torch.cli import main\n"
        f"sys.exit(main(['serve', '--bundle', {tiny_bundle!r}, '--port', '{port}', "
        "'--dtype', 'float32', '--max-length', '64'], device='cpu'))\n"
    )
    proc = subprocess.Popen([sys.executable, "-c", child], cwd=ROOT,
                            env=dict(os.environ, PYTHONPATH=ROOT),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 60
        up = False
        while time.monotonic() < deadline and proc.poll() is None:
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=2) as r:
                    up = json.loads(r.read())["status"] == "ok"
                break
            except OSError:
                time.sleep(0.2)
        assert up, f"server never came up (rc={proc.poll()})"
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=30)
        assert rc == 0, f"serve exited {rc} on SIGTERM: {proc.stderr.read()}"
        assert "jax" not in proc.stderr.read().lower()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
