"""The (data, seq, model) mesh over ``torch.distributed`` ranks.

The port of ``gliclass.c_tpu.parallel.mesh``. JAX lays a 3-D device mesh
over ``jax.devices()`` and lets XLA's SPMD partitioner insert the
collectives; here each rank is one process driving one device, and the mesh
gives it its coordinates and the process groups whose collectives the port
issues itself (``parallel.collectives``):

    data     the ranks that hold the same shards and the same tokens (data parallel)
    seq      the ranks that together hold one sequence's tokens (sequence parallel)
    model    the ranks that together hold one copy of the model (tensor parallel)
    control  every rank, over gloo on the host: the serving leader's broadcasts
             of each forward's inputs (``engine.InferenceEngine.lead``/``follow``)

The rank layout is the JAX one: tp innermost (adjacent ranks, the closest
links), then sp, dp outermost: rank = (d * sp + s) * tp + t.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist

from .distributed import LAUNCHER_VARS, new_control_group


@dataclass(frozen=True)
class Mesh:
    dp: int
    sp: int
    tp: int
    data_rank: int  # this rank's coordinate on the data axis
    model_rank: int  # and on the model axis
    device: torch.device
    data_group: Any = None  # ProcessGroup of this rank's data axis; None with dp == 1
    model_group: Any = None  # ProcessGroup of this rank's model axis; None with tp == 1
    seq_rank: int = 0  # this rank's coordinate on the seq axis
    seq_group: Any = None  # ProcessGroup of this rank's seq axis; None with sp == 1
    control_group: Any = None  # gloo group of every rank; None on one rank

    @property
    def size(self) -> int:
        return self.dp * self.sp * self.tp


def make_mesh(dp: int = 1, tp: int = 1, sp: int = 1, device=None) -> Mesh:
    """This rank's mesh of ``dp * sp * tp`` ranks, which must be the world
    (:func:`~.distributed.initialize_from_env`). ``device``: this rank's
    device (default the current card). Every rank must call it, in the same
    order as its other group creations: ``dist.new_group`` is collective."""
    if dp < 1 or sp < 1 or tp < 1:
        raise ValueError(f"mesh sizes must be positive, got dp={dp}, sp={sp}, tp={tp}")
    n = dp * sp * tp
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n != world:
        hint = "" if dist.is_initialized() else f"; launch {n} processes with {LAUNCHER_VARS} set"
        raise ValueError(f"mesh {dp}x{sp}x{tp} needs {n} ranks, the world has {world}{hint}")
    dev = torch.device(device) if device is not None else torch.device("cuda")
    if n == 1:
        return single_device_mesh(dev)
    rank = dist.get_rank()
    d, s, t = rank // (sp * tp), rank // tp % sp, rank % tp
    at = lambda dd, ss, tt: (dd * sp + ss) * tp + tt
    # new_group is collective over the whole world: every rank creates every
    # group, in this order, and keeps its own.
    groups = {}
    for axis, size, members in (
        ("model", tp, lambda dd, ss, tt: [at(dd, ss, x) for x in range(tp)]),
        ("seq", sp, lambda dd, ss, tt: [at(dd, x, tt) for x in range(sp)]),
        ("data", dp, lambda dd, ss, tt: [at(x, ss, tt) for x in range(dp)]),
    ):
        if size == 1:
            continue
        made = {}
        for dd in range(dp):
            for ss in range(sp):
                for tt in range(tp):
                    key = tuple(members(dd, ss, tt))
                    if key not in made:
                        made[key] = dist.new_group(list(key))
        groups[axis] = made[tuple(members(d, s, t))]
    return Mesh(dp, sp, tp, d, t, dev, groups.get("data"), groups.get("model"), s, groups.get("seq"),
                new_control_group())


def single_device_mesh(device=None) -> Mesh:
    """The one-rank mesh: no process group, no collective."""
    return Mesh(1, 1, 1, 0, 0, torch.device(device) if device is not None else torch.device("cuda"))
