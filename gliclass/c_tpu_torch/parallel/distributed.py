"""Multi-process bootstrap: one process per rank over ``torch.distributed``.

The port of ``gliclass.c_tpu.parallel.distributed``. One launcher drives both
packages: :func:`initialize_from_env` reads the JAX package's variables
(``COORDINATOR_ADDRESS``, ``NUM_PROCESSES``, ``PROCESS_ID``) and torchrun's
(``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``). Each process drives one device: with ``nccl`` card
``LOCAL_RANK``; with ``gloo`` on the card (several ranks may share one)
card ``LOCAL_RANK`` modulo the cards of the host.

The JAX package's ``GLICLASS_TPU_AUTO_DISTRIBUTED`` (Cloud-TPU metadata
autodetection) has no counterpart: a GPU host has no such metadata server,
so the variables above are the only source.
"""

from __future__ import annotations

import datetime

import torch
import torch.distributed as dist

from ..config import launch_world

# Named in the errors of a multi-rank run without a launch.
LAUNCHER_VARS = ("COORDINATOR_ADDRESS/NUM_PROCESSES/PROCESS_ID (the JAX package's) or "
                 "MASTER_ADDR/MASTER_PORT/RANK/WORLD_SIZE (torchrun's)")


def initialize_from_env(backend: str | None = None, device=None) -> bool:
    """Initialise the default process group from the launcher's variables.
    Returns False, doing nothing, when neither set is present (or the group
    exists already: True then).

    ``device``: "cpu", or None/"cuda" for the card. ``backend`` defaults to
    ``nccl`` on the card and ``gloo`` on the CPU; nothing switches it
    silently. NCCL takes one card per rank, so with more ranks on the host
    than cards it raises (``backend="gloo"`` runs several ranks on one card,
    its collectives staged through host memory)."""
    if dist.is_initialized():
        return True
    spec = launch_world()
    if spec is None:
        return False
    init, world, rank, lrank, lworld = spec
    on_card = device is None or torch.device(device).type == "cuda"
    backend = backend or ("nccl" if on_card else "gloo")
    if on_card:
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("no CUDA device: pass device='cpu' to run the ranks on the CPU")
        if backend == "nccl" and lworld > n:
            raise RuntimeError(
                f"{lworld} ranks on this host but {n} CUDA device(s): NCCL takes one device per rank; "
                'initialize_from_env(backend="gloo") runs several ranks on one card'
            )
        torch.cuda.set_device(lrank % n)
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank)
    return True


# A serving follower waits on the control group for the next forward as long
# as the server is idle: far past the 30-minute default of a gloo collective.
CONTROL_TIMEOUT = datetime.timedelta(days=365)


def new_control_group():
    """A gloo group of every rank on the host, whatever the compute backend:
    the control plane of lockstep serving, where the leader broadcasts each
    forward's header and host arrays and no follower waits on its device for
    one. Collective: every rank calls it, in its order among the other
    group creations (``parallel.mesh.make_mesh`` does). A follower blocked
    in a broadcast raises when gloo reports the leader's closed connection."""
    return dist.new_group(backend="gloo", timeout=CONTROL_TIMEOUT)


def process_info() -> dict:
    """The JAX function's keys. Each process drives one device, so the
    global device count is the world size."""
    on = dist.is_initialized()
    world = dist.get_world_size() if on else 1
    return {
        "process_index": dist.get_rank() if on else 0,
        "process_count": world,
        "local_devices": 1,
        "global_devices": world,
    }
