"""One rank of the CPU gloo worlds that tests/test_torch_parallel.py starts.

    MASTER_ADDR=... MASTER_PORT=... RANK=r WORLD_SIZE=n python torch_parallel_worker.py CASES.pkl OUT_DIR

Reads the cases the test wrote (numpy parameters and batches, configs as
dicts), runs those of its world size through the port on the CPU, each on
its own mesh ((dp, tp) or (dp, sp, tp)), and writes ``OUT_DIR/rank{r}.pkl``:
{case name: result}. A "serve" case serves HTTP requests from rank 0 over
the mesh (the others follow) with :func:`serve_requests`, which the test
also calls on one process. Imports torch and the port only; the test holds
the results to JAX.
"""

import functools
import json
import os
import pickle
import sys
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed as dist


def _cfg(spec):
    from gliclass.c_tpu_torch.config import BackboneConfig, GLiClassConfig

    bb, head = spec
    return GLiClassConfig(backbone=BackboneConfig(**bb), **head)


def _infer(case, mesh):
    from gliclass.c_tpu_torch.config import RuntimeConfig
    from gliclass.c_tpu_torch.engine import InferenceEngine
    from gliclass.c_tpu_torch.tokenization import TokenizedBatch

    from gliclass.c_tpu_torch.parallel import collectives

    rt = RuntimeConfig(compute_dtype=case["dtype"], quant_mode=case["quant"], dp_size=mesh.dp, sp_size=mesh.sp,
                       tp_size=mesh.tp, fuse_qkv=case.get("fuse_qkv", False))
    engine = InferenceEngine(_cfg(case["cfg"]), case["params"], rt, device="cpu", mesh=mesh)
    calls = collectives.calls
    out = [engine.run(TokenizedBatch(*b), case["max_labels"]) for b in case["batches"]]
    return {"probs": out, "plan": sorted(engine.plan.pairs), "calls": collectives.calls - calls}


def _post(port, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/classify", data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def serve_requests(engine, tokenizer, runtime, requests, clients=4):
    """Serve ``requests`` (POST /classify bodies) from ``clients`` threads
    through a GLiClassServer over ``engine`` on an ephemeral port; close it
    (stopping a mesh's followers) and return the answers in request order."""
    from gliclass.c_tpu_torch.serving import GLiClassServer

    engine.lead()
    server = GLiClassServer(engine, tokenizer, runtime, port=0, max_wait_ms=2.0)
    server.start()
    try:
        with ThreadPoolExecutor(clients) as ex:
            return list(ex.map(functools.partial(_post, server.port), requests))
    finally:
        server.close()


def _serve(case, mesh):
    from gliclass.c_tpu_torch.config import RuntimeConfig
    from gliclass.c_tpu_torch.engine import InferenceEngine
    from gliclass.c_tpu_torch.tokenization import PromptTokenizer

    rt = RuntimeConfig(compute_dtype="float32", max_length=64, batch_size=8, dp_size=mesh.dp, sp_size=mesh.sp,
                       tp_size=mesh.tp)
    engine = InferenceEngine(_cfg(case["cfg"]), case["params"], rt, device="cpu", mesh=mesh)
    if dist.get_rank() != 0:
        return {"follow": engine.follow()}
    return {"answers": serve_requests(engine, PromptTokenizer.from_file(case["tokenizer"]), rt, case["requests"])}


def _train(case, mesh):
    from gliclass.c_tpu_torch.training import train as T
    from gliclass.c_tpu_torch.training.checkpoint import save_train_state

    opt = {"sgd": functools.partial(torch.optim.SGD, lr=case["lr"]),
           "adamw": functools.partial(torch.optim.AdamW, lr=case["lr"], weight_decay=1e-4)}[case["opt"]]
    cfg = _cfg(case["cfg"])
    state = T.init_sharded_train_state(case["params"], opt, mesh, cfg)
    step = T.make_sharded_train_step(cfg, case["max_labels"], mesh)
    batch = T.shard_batch(mesh, *case["batch"])
    metrics = []
    for _ in range(case["steps"]):
        state, m = step(state, *batch)
        metrics.append({k: float(v) for k, v in m.items()})
    if case.get("ckpt"):
        save_train_state(case["ckpt"], state)
    return {"metrics": metrics}


def main(cases_path: str, out_dir: str) -> int:
    from gliclass.c_tpu_torch.parallel.distributed import initialize_from_env, process_info
    from gliclass.c_tpu_torch.parallel.mesh import make_mesh

    if not initialize_from_env(device="cpu"):
        raise SystemExit("no launcher variables")
    world, rank = dist.get_world_size(), dist.get_rank()
    with open(cases_path, "rb") as f:
        cases = pickle.load(f)
    out = {"process_info": process_info(), "backend": dist.get_backend()}
    for case in cases:
        if case["world"] != world:
            continue
        m = case["mesh"]
        dp, sp, tp = (m[0], 1, m[1]) if len(m) == 2 else m
        mesh = make_mesh(dp, tp, sp, device="cpu")
        out[case["name"]] = {"infer": _infer, "train": _train, "serve": _serve}[case["kind"]](case, mesh)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(*sys.argv[1:]))
