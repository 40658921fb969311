"""The port's data and tensor parallelism against the JAX package's, on CPU.

The sharding rules and local shards are checked in this process. The
multi-rank paths run in two CPU gloo worlds, of 2 and of 4 ranks
(``torch_parallel_worker.py``, started once each, all their cases inside),
while this process computes JAX's results at the same meshes on its 8
virtual devices (``conftest.py``):

  * probabilities of the tiny DeBERTa and Llama of ``test_sharding.py`` at
    (dp, tp) in {(2,1), (1,2), (2,2), (1,4)}, fp32 and weight-only INT8, a
    full and a ragged batch, against JAX's ``InferenceEngine`` at 1e-5;
    ``int8-dynamic`` at tp = 2 against JAX at ``test_torch_model.py``'s
    4.2e-2; GQA with 8 query and 2 kv heads at tp = 4;
  * one SGD step of the sharded train step at (2,1), (1,2), (2,2) against
    JAX's ``make_sharded_train_step`` (loss 1e-5, grad norm and parameters
    1e-4), AdamW's loss falling over two steps, and a checkpoint saved at
    tp = 2 restored into one process.
"""

import dataclasses
import functools
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import optax

from gliclass.c_tpu.config import RuntimeConfig as JRuntimeConfig
from gliclass.c_tpu.engine import InferenceEngine as JEngine
from gliclass.c_tpu.models.gliclass import init_gliclass_params
from gliclass.c_tpu.ops.quant import quantize_tree
from gliclass.c_tpu.parallel import mesh as jmesh
from gliclass.c_tpu.parallel.sharding import param_pspecs as j_param_pspecs
from gliclass.c_tpu.tokenization import PromptTokenizer
from gliclass.c_tpu.training import train as jtrain
from gliclass.c_tpu_torch import config as tcfg
from gliclass.c_tpu_torch.convert.params import params_from_numpy
from gliclass.c_tpu_torch.ops import fused_ffn as FF
from gliclass.c_tpu_torch.ops.layers import row_quant_amax
from gliclass.c_tpu_torch.parallel import distributed as tdist
from gliclass.c_tpu_torch.parallel.mesh import Mesh
from gliclass.c_tpu_torch.parallel.sharding import local_shard_dims, param_pspecs, shard_params, shard_plan
from gliclass.c_tpu_torch.training import train as ttrain
from gliclass.c_tpu_torch.training.checkpoint import restore_train_state

import test_sharding
import test_training
from test_torch_heads import jittered

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_parallel_worker.py")
MESHES = {2: [(2, 1), (1, 2)], 4: [(2, 2), (1, 4)]}
TRAIN_MESHES = {2: [(2, 1), (1, 2)], 4: [(2, 2)]}


def cfg_dicts(jc):
    """A JAX GLiClassConfig as the (backbone, head) kwargs of both packages."""
    head = {f.name: getattr(jc, f.name) for f in dataclasses.fields(jc) if f.name != "backbone"}
    return dataclasses.asdict(jc.backbone), head


def port_cfg(jc):
    bb, head = cfg_dicts(jc)
    return tcfg.GLiClassConfig(backbone=tcfg.BackboneConfig(**bb), **head)


def batch_arrays(b):
    return (np.asarray(b.input_ids, np.int32), np.asarray(b.attention_mask, np.int32), np.asarray(b.lengths, np.int32))


class Models:
    """The configurations, parameters and batches the worlds and JAX share."""

    def __init__(self, tok):
        self.tok = tok
        self.cfg = {m: test_sharding.tiny_cfg(tok, m) for m in ("deberta-v2", "llama")}
        gqa = dataclasses.replace(self.cfg["llama"].backbone, num_key_value_heads=2)
        self.cfg["gqa"] = dataclasses.replace(self.cfg["llama"], backbone=gqa)
        self.params = {m: jittered(init_gliclass_params(jax.random.key(0), c)) for m, c in self.cfg.items()}
        self.qparams = {m: quantize_tree(p) for m, p in self.params.items()}
        self.batches = [test_sharding.make_batch(tok, 8), test_sharding.make_batch(tok, 5)]
        self.tcfg = test_training.tiny_cfg()
        self.tparams = jittered(init_gliclass_params(jax.random.key(1), self.tcfg))
        self.tbatch = tuple(np.array(a) for a in test_training.make_batch(np.random.default_rng(2)))

    def infer_cases(self, ckpt_dir):
        cases = []

        def add(name, world, mesh, model, quant, dtype, params, **kw):
            cases.append(dict(kind="infer", name=name, world=world, mesh=mesh, cfg=cfg_dicts(self.cfg[model]),
                              params=params, quant=quant, dtype=dtype, max_labels=4,
                              batches=[batch_arrays(b) for b in self.batches], **kw))

        for world, meshes in MESHES.items():
            for mesh in meshes:
                for model in ("deberta-v2", "llama"):
                    add(f"{model}-fp32-{mesh}", world, mesh, model, "none", "float32", self.params[model])
                    add(f"{model}-int8-{mesh}", world, mesh, model, "int8", "float32", self.qparams[model])
        add("deberta-v2-dyn-(1, 2)", 2, (1, 2), "deberta-v2", "int8-dynamic", "bfloat16", self.qparams["deberta-v2"])
        add("deberta-v2-fused-(1, 2)", 2, (1, 2), "deberta-v2", "none", "float32", self.params["deberta-v2"],
            fuse_qkv=True)
        add("gqa-fp32-(1, 4)", 4, (1, 4), "gqa", "none", "float32", self.params["gqa"])
        for world, meshes in TRAIN_MESHES.items():
            for mesh in meshes:
                for opt, lr, steps in (("sgd", 1e-2, 1), ("adamw", 1e-3, 2)):
                    cases.append(dict(kind="train", name=f"train-{opt}-{mesh}", world=world, mesh=mesh,
                                      cfg=cfg_dicts(self.tcfg), params=self.tparams, batch=self.tbatch, opt=opt,
                                      lr=lr, steps=steps, max_labels=4,
                                      ckpt=os.path.join(ckpt_dir, f"{opt}-{mesh[0]}x{mesh[1]}.pt")))
        return cases


class Worlds:
    """The two gloo worlds, started at once; :meth:`results` waits for one."""

    def __init__(self, cases, tmp):
        self.out, self.procs = {}, {}
        path = os.path.join(tmp, "cases.pkl")
        with open(path, "wb") as f:
            pickle.dump(cases, f)
        for world in MESHES:
            out = os.path.join(tmp, f"world{world}")
            os.makedirs(out)
            with socket.socket() as s:
                s.bind(("127.0.0.1", 0))
                port = s.getsockname()[1]
            env = dict(os.environ, PYTHONPATH=ROOT, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                       WORLD_SIZE=str(world), OMP_NUM_THREADS="1")
            self.out[world] = out
            self.procs[world] = [
                subprocess.Popen([sys.executable, WORKER, path, out], env=dict(env, RANK=str(r)), cwd=ROOT,
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for r in range(world)]
        self._done = {}

    def results(self, world):
        if world not in self._done:
            logs = [p.communicate(timeout=600)[0] for p in self.procs[world]]
            codes = [p.returncode for p in self.procs[world]]
            assert codes == [0] * world, "\n".join(l[-3000:] for l in logs)
            self._done[world] = []
            for r in range(world):
                with open(os.path.join(self.out[world], f"rank{r}.pkl"), "rb") as f:
                    self._done[world].append(pickle.load(f))
        return self._done[world]

    def case(self, name):
        """The case's result on each rank of its world."""
        for world in MESHES:
            res = self.results(world)
            if name in res[0]:
                return [r[name] for r in res]
        raise KeyError(name)


@pytest.fixture(scope="module")
def models(tiny_tokenizer_file):
    return Models(PromptTokenizer.from_file(tiny_tokenizer_file))


@pytest.fixture(scope="module")
def worlds(models, tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("worlds"))
    w = Worlds(models.infer_cases(tmp), tmp)
    w.ckpt_dir = tmp
    yield w
    for procs in w.procs.values():
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


def jax_probs(cfg, params, mesh, batch, quant="none", dtype="float32"):
    rt = JRuntimeConfig(compute_dtype=dtype, quant_mode=quant, dp_size=mesh[0], tp_size=mesh[1])
    return JEngine(cfg, params, rt).run(batch, max_labels=4)


# ---------------------------------------------------------------------------
# In this process: the rules and the local shards
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("model", ["deberta-v2", "llama"])
def test_param_pspecs_match_jax(models, model):
    """Per leaf, the dim the port shards is where JAX's spec puts "model"."""
    params = models.qparams[model]
    want = jax.tree.map(lambda s: s.index(jmesh.MODEL_AXIS) if jmesh.MODEL_AXIS in tuple(s) else None,
                        j_param_pspecs(params), is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert param_pspecs(params) == want


def local(params, cfg, tp, rank):
    return shard_params(params_from_numpy(params, "cpu"), Mesh(1, 1, tp, 0, rank, torch.device("cpu")), cfg)


@pytest.mark.parametrize("tp", [2, 4])
def test_local_shards_are_one_tp_th(models, tp):
    """Column layers keep 1/tp of their output dim, row layers of their
    input dim; row biases, norms and embeddings stay whole; the shards,
    concatenated, are the whole weight."""
    p = models.params["deberta-v2"]
    cfg = models.cfg["deberta-v2"]
    parts = [local(p, cfg, tp, r) for r in range(tp)]
    at, ffn = p["backbone"]["layers"]["attn"], p["backbone"]["layers"]["ffn"]
    L0 = parts[0]["backbone"]["layers"]
    assert L0["attn"]["q"]["w"].shape == (2, 64, 64 // tp) and L0["attn"]["o"]["w"].shape == (2, 64 // tp, 64)
    assert L0["ffn"]["up"]["b"].shape == (2, 128 // tp) and L0["ffn"]["down"]["b"].shape == (2, 64)
    assert parts[0]["head"]["text_projector"]["linear_2"]["w"].shape == (256 // tp, 64)
    assert L0["attn"]["ln"]["scale"].shape == (2, 64)
    assert parts[0]["backbone"]["embeddings"]["word"].shape == p["backbone"]["embeddings"]["word"].shape
    cat = lambda get, dim: torch.cat([get(q) for q in parts], dim=dim).numpy()
    np.testing.assert_array_equal(cat(lambda q: q["backbone"]["layers"]["attn"]["k"]["w"], -1), at["k"]["w"])
    np.testing.assert_array_equal(cat(lambda q: q["backbone"]["layers"]["ffn"]["down"]["w"], -2), ffn["down"]["w"])
    plan = shard_plan(p, tp, cfg)
    assert plan.pairs == {"attn", "ffn", "text_projector", "classes_projector"} and plan.kv_share == 1
    dims = local_shard_dims(parts[0], plan)
    assert dims["backbone"]["layers"]["attn"]["o"]["w"] == 1 and dims["backbone"]["layers"]["attn"]["o"]["b"] is None


def test_head_aligned_and_gqa_cuts(models):
    """Heads that do not divide by tp keep the attention whole (not a column
    cut through a head); GQA with 2 kv heads at tp = 4 gives each rank its
    2 query heads and the one kv head they read; a fused qkv is cut by head."""
    jc = models.cfg["deberta-v2"]  # 8 heads
    p = models.params["deberta-v2"]
    plan = shard_plan(p, 16, jc)
    assert "attn" not in plan.pairs
    at = local(p, jc, 16, 3)["backbone"]["layers"]["attn"]
    assert at["q"]["w"].shape == (2, 64, 64) and at["o"]["w"].shape == (2, 64, 64)

    g = models.cfg["gqa"]
    gp = models.params["gqa"]
    assert shard_plan(gp, 4, g).kv_share == 2
    for r in range(4):
        a = local(gp, g, 4, r)["backbone"]["layers"]["attn"]
        assert a["q"]["w"].shape == (2, 64, 16) and a["k"]["w"].shape == (2, 64, 8)
        np.testing.assert_array_equal(a["k"]["w"].numpy(), gp["backbone"]["layers"]["attn"]["k"]["w"][..., r // 2 * 8:(r // 2 + 1) * 8])
    # 3 kv heads at tp = 2: no integer GQA ratio per rank, the attention stays whole.
    odd = dataclasses.replace(g, backbone=dataclasses.replace(g.backbone, num_attention_heads=6, num_key_value_heads=3))
    assert "attn" not in shard_plan(gp, 2, odd).pairs

    from gliclass.c_tpu_torch.engine import fuse_qkv_params

    whole = fuse_qkv_params(params_from_numpy(p, "cpu"), port_cfg(jc))
    a = local(whole, jc, 2, 1)["backbone"]["layers"]["attn"]["qkv"]["w"]
    q, k, v = (whole["backbone"]["layers"]["attn"]["qkv"]["w"][..., i * 64:(i + 1) * 64] for i in range(3))
    np.testing.assert_array_equal(a.numpy(), torch.cat([t[..., 32:] for t in (q, k, v)], -1).numpy())


def test_split_k2_plain_bit_equal_to_one_rank():
    """The plain split K2 at tp = 2: each rank's up half on its columns, the
    maximum of the row absmax, the down halves; h_q and s_h equal tp = 1's
    bit for bit, and the summed outputs agree with the fused plain K2."""
    rng = np.random.default_rng(0)
    M, H, I = 64, 32, 128
    x = torch.from_numpy(rng.standard_normal((M, H), dtype=np.float32)).to(torch.bfloat16)
    wq_up = torch.from_numpy(rng.integers(-127, 128, (H, I), dtype=np.int8))
    wq_dn = torch.from_numpy(rng.integers(-127, 128, (I, H), dtype=np.int8))
    s_up, s_dn = (torch.from_numpy(rng.uniform(1e-3, 2e-3, n).astype(np.float32)) for n in (I, H))
    b_up, b_dn = (torch.from_numpy(rng.standard_normal(n).astype(np.float32) * 0.1) for n in (I, H))
    h1, a1 = FF.ffn_w8a8_up_plain(x, wq_up, s_up, b_up)
    hq1, s1 = row_quant_amax(h1, a1)
    cols = [slice(0, I // 2), slice(I // 2, I)]
    halves = [FF.ffn_w8a8_up_plain(x, wq_up[:, c], s_up[c], b_up[c]) for c in cols]
    amax = torch.maximum(halves[0][1], halves[1][1])
    split = [row_quant_amax(h, amax) for h, _ in halves]
    assert torch.equal(torch.cat([q for q, _ in split], -1), hq1)
    assert all(torch.equal(s, s1) for _, s in split)
    y = sum(FF.ffn_w8a8_down_plain(h, amax, wq_dn[c], s_dn) for (h, _), c in zip(halves, cols)) + b_dn
    ref = FF.fused_ffn_w8a8_plain(x, wq_up, s_up, b_up, wq_dn, s_dn, b_dn).float()
    np.testing.assert_allclose(y.to(torch.bfloat16).float().numpy(), ref.numpy(), rtol=1e-2, atol=1e-2)
    assert torch.equal(FF.ffn_w8a8_down_plain(h1, a1, wq_dn, s_dn, b_dn).to(torch.bfloat16),
                       FF.fused_ffn_w8a8_plain(x, wq_up, s_up, b_up, wq_dn, s_dn, b_dn))


def test_initialize_from_env_without_variables(monkeypatch):
    for k in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID", "MASTER_ADDR", "MASTER_PORT", "RANK",
              "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert tdist.initialize_from_env(device="cpu") is False
    assert tdist.process_info() == {"process_index": 0, "process_count": 1, "local_devices": 1, "global_devices": 1}


def test_parallel_modules_import_no_jax():
    code = ("import sys; import gliclass.c_tpu_torch.parallel.distributed, gliclass.c_tpu_torch.parallel.mesh, "
            "gliclass.c_tpu_torch.parallel.collectives, gliclass.c_tpu_torch.parallel.sharding, "
            "gliclass.c_tpu_torch.training.train, gliclass.c_tpu_torch.training.checkpoint; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib') or "
            "(m.startswith('gliclass.c_tpu') and not m.startswith('gliclass.c_tpu_torch'))]; print(bad)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


# ---------------------------------------------------------------------------
# The worlds against JAX at the same mesh
# ---------------------------------------------------------------------------
def test_process_info_in_two_ranks(worlds):
    res = worlds.results(2)
    assert [r["process_info"] for r in res] == [
        {"process_index": i, "process_count": 2, "local_devices": 1, "global_devices": 2} for i in range(2)]
    assert {r["backend"] for r in res} == {"gloo"}


@pytest.mark.parametrize("quant", ["fp32", "int8"])
@pytest.mark.parametrize("model", ["deberta-v2", "llama"])
@pytest.mark.parametrize("mesh", [m for ms in MESHES.values() for m in ms], ids=str)
def test_probs_match_jax_engine_at_same_mesh(models, worlds, model, quant, mesh):
    """Full batch of 8 and ragged batch of 5 (padded to a multiple of dp),
    every rank's gathered probabilities, to 1e-5."""
    params = (models.params if quant == "fp32" else models.qparams)[model]
    want = [jax_probs(models.cfg[model], params, mesh, b) for b in models.batches]
    res = worlds.case(f"{model}-{quant}-{mesh}")
    for r in res:
        for got, w in zip(r["probs"], want):
            assert got.shape == w.shape
            np.testing.assert_allclose(got, w, atol=1e-5, rtol=1e-5)
    if mesh[1] > 1:
        assert "attn" in res[0]["plan"] and ({"ffn"} if model == "deberta-v2" else {"mlp"}) <= set(res[0]["plan"])


def test_int8_dynamic_tp2_matches_jax(models, worlds):
    """w8a8 at tp = 2 (the o projection's row absmax and K2's s_h reduced
    with MAX over the model group) against JAX at test_torch_model.py's
    bf16 bound."""
    want = [jax_probs(models.cfg["deberta-v2"], models.qparams["deberta-v2"], (1, 2), b, "int8-dynamic", "bfloat16")
            for b in models.batches]
    for r in worlds.case("deberta-v2-dyn-(1, 2)"):
        for got, w in zip(r["probs"], want):
            np.testing.assert_allclose(got, w, atol=4.2e-2)


def test_fused_qkv_and_gqa_match_jax(models, worlds):
    """q/k/v fused after sharding (per head) at tp = 2; GQA with 8 query and
    2 kv heads at tp = 4 (each rank one kv head)."""
    for name, model, mesh in (("deberta-v2-fused-(1, 2)", "deberta-v2", (1, 2)), ("gqa-fp32-(1, 4)", "gqa", (1, 4))):
        want = [jax_probs(models.cfg[model], models.params[model], mesh, b) for b in models.batches]
        for r in worlds.case(name):
            for got, w in zip(r["probs"], want):
                np.testing.assert_allclose(got, w, atol=1e-5, rtol=1e-5)


def jax_train(models, mesh, opt, steps):
    jm = jmesh.make_mesh(*mesh)
    state = jtrain.init_sharded_train_state(models.tparams, opt, jm)
    step = jtrain.make_sharded_train_step(models.tcfg, opt, 4, jm)
    batch = jtrain.shard_batch(jm, *models.tbatch)
    metrics = []
    for _ in range(steps):
        state, m = step(state, *batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree) for k, v in flat(tree[key], f"{prefix}{key}/").items()}
    return {prefix[:-1]: np.asarray(tree.detach() if isinstance(tree, torch.Tensor) else tree)}


@pytest.mark.parametrize("mesh", [m for ms in TRAIN_MESHES.values() for m in ms], ids=str)
def test_sharded_sgd_step_matches_jax(models, worlds, mesh):
    """Loss to 1e-5, grad norm to 1e-4 and the gathered parameters (the
    checkpoint rank 0 wrote) to 1e-4 against JAX's sharded step; the same
    metrics on every rank."""
    jstate, (jm,) = jax_train(models, mesh, optax.sgd(1e-2), 1)
    res = worlds.case(f"train-sgd-{mesh}")
    for r in res:
        (m,) = r["metrics"]
        np.testing.assert_allclose(m["loss"], jm["loss"], rtol=1e-5)
        np.testing.assert_allclose(m["grad_norm"], jm["grad_norm"], rtol=1e-4)
        np.testing.assert_allclose(m["accuracy"], jm["accuracy"], rtol=1e-6)
    saved = torch.load(os.path.join(worlds.ckpt_dir, f"sgd-{mesh[0]}x{mesh[1]}.pt"), weights_only=True)
    want = flat(jax.tree.map(np.asarray, jstate.params))
    assert saved["params"].keys() == want.keys()
    for k, w in want.items():
        np.testing.assert_allclose(saved["params"][k].numpy(), w, rtol=1e-4, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("mesh", [m for ms in TRAIN_MESHES.values() for m in ms], ids=str)
def test_sharded_adamw_loss_falls(worlds, mesh):
    for r in worlds.case(f"train-adamw-{mesh}"):
        l1, l2 = (m["loss"] for m in r["metrics"])
        assert np.isfinite(l1) and l2 < l1


def test_checkpoint_saved_at_tp2_restores_into_one_process(models, worlds):
    """The AdamW state saved at (1, 2) (params and moments gathered) loads
    into a one-process state: its next step is the sharded run's next step."""
    worlds.case("train-adamw-(1, 2)")
    cfg = port_cfg(models.tcfg)
    adamw = functools.partial(torch.optim.AdamW, lr=1e-3, weight_decay=1e-4)
    like = ttrain.init_train_state(models.tparams, adamw, device="cpu")
    state = restore_train_state(os.path.join(worlds.ckpt_dir, "adamw-1x2.pt"), like)
    assert state.step == 2
    saved = torch.load(os.path.join(worlds.ckpt_dir, "adamw-1x2.pt"), weights_only=True)
    for k, v in flat(state.params).items():
        np.testing.assert_array_equal(v, saved["params"][k].numpy())
    moments = state.optimizer.state_dict()["state"]
    assert all(moments[i]["exp_avg"].shape == t.shape for i, t in enumerate(ttrain.param_leaves(state.params)))
    # A third step from the restored state against JAX's third AdamW step.
    # Adam's first updates are about lr * sign(g), so the sum order of two
    # sharded steps moves this loss by about 1e-5 (relative).
    _, jm = jax_train(models, (1, 2), optax.adamw(1e-3, weight_decay=1e-4), 3)
    _, m = ttrain.make_train_step(cfg, 4)(state, *models.tbatch)
    np.testing.assert_allclose(float(m["loss"]), jm[2]["loss"], rtol=1e-4)
