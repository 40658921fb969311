"""Two NCCL ranks on one card: what NCCL says, and what the port says first.

    python3 scripts/nccl_two_ranks_one_card.py

(1) ``initialize_from_env()`` with two local ranks on a host with one card:
the port refuses NCCL before it starts (it names ``backend="gloo"``).
(2) The same two ranks calling ``torch.distributed.init_process_group("nccl")``
themselves, both on cuda:0, and one all-reduce: NCCL's own answer. Each
rank prints its outcome; the script stops both after 120 s.
"""

import multiprocessing as mp
import os
import socket
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def rank_main(rank: int, port: int, q) -> None:
    import torch
    import torch.distributed as dist

    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), RANK=str(rank), WORLD_SIZE="2",
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE="2")
    from gliclass.c_tpu_torch.parallel.distributed import initialize_from_env

    try:
        initialize_from_env()
        q.put((rank, "port", "initialize_from_env accepted two NCCL ranks on one card"))
    except RuntimeError as e:
        q.put((rank, "port", f"initialize_from_env refused: {e}"))
    try:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port + 1}", world_size=2, rank=rank)
        t = torch.ones(4, device="cuda")
        dist.all_reduce(t)
        torch.cuda.synchronize()
        q.put((rank, "nccl", f"all-reduce gave {t.tolist()}"))
        dist.destroy_process_group()
    except Exception as e:  # the outcome being probed: reported, and the rank ends
        q.put((rank, "nccl", f"{type(e).__name__}: {str(e)[:600]}"))


def main() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=rank_main, args=(r, port, q)) for r in range(2)]
    for p in procs:
        p.start()
    msgs = []
    try:
        while len(msgs) < 4:
            msgs.append(q.get(timeout=120))
    except Exception:
        msgs.append((None, "probe", "no answer within 120 s"))
    for p in procs:
        p.join(5)
        if p.is_alive():
            p.terminate()
            p.join()
    for rank, what, msg in sorted(msgs, key=lambda m: (str(m[1]), str(m[0]))):
        print(f"rank {rank} [{what}]: {msg}", flush=True)
    print(f"exit codes {[p.exitcode for p in procs]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
