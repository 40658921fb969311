"""The (data, seq, model) mesh over ``torch.distributed`` ranks.

The port of ``gliclass.c_tpu.parallel.mesh``. JAX lays a 3-D device mesh
over ``jax.devices()`` and lets XLA's SPMD partitioner insert the
collectives; here each rank is one process driving one device, and the mesh
gives it its coordinates and the two process groups whose collectives the
port issues itself (``parallel.collectives``):

    data   the ranks that hold the same shards of the model (data parallel)
    model  the ranks that together hold one copy of the model (tensor parallel)

The rank layout is the JAX one: tp innermost (adjacent ranks, the closest
links), dp outermost: rank = d * tp + t.

Sequence parallelism (``sp > 1``) is not ported (ROADMAP.md queue 1, item
8): the attention kernels take no query-row offset.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
import torch.distributed as dist

from .distributed import LAUNCHER_VARS


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

    @property
    def size(self) -> int:
        return self.dp * self.sp * self.tp


def make_mesh(dp: int = 1, tp: int = 1, sp: int = 1, device=None) -> Mesh:
    """This rank's mesh of ``dp * sp * tp`` ranks, which must be the world
    (:func:`~.distributed.initialize_from_env`). ``device``: this rank's
    device (default the current card). Every rank must call it, in the same
    order as its other group creations: ``dist.new_group`` is collective."""
    if sp != 1:
        raise ValueError(
            f"sp={sp}: sequence parallelism is not ported (ROADMAP.md queue 1, item 8); "
            "the attention kernels take no query-row offset"
        )
    if dp < 1 or tp < 1:
        raise ValueError(f"mesh sizes must be positive, got dp={dp}, tp={tp}")
    n = dp * sp * tp
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n != world:
        hint = "" if dist.is_initialized() else f"; launch {n} processes with {LAUNCHER_VARS} set"
        raise ValueError(f"mesh {dp}x{sp}x{tp} needs {n} ranks, the world has {world}{hint}")
    dev = torch.device(device) if device is not None else torch.device("cuda")
    if n == 1:
        return single_device_mesh(dev)
    rank = dist.get_rank()
    d, t = divmod(rank, tp)
    data_group = model_group = None
    # new_group is collective over the whole world: every rank creates every
    # group, in this order, and keeps its own.
    if tp > 1:
        for dd in range(dp):
            g = dist.new_group([dd * tp + tt for tt in range(tp)])
            if dd == d:
                model_group = g
    if dp > 1:
        for tt in range(tp):
            g = dist.new_group([dd * tp + tt for dd in range(dp)])
            if tt == t:
                data_group = g
    return Mesh(dp, sp, tp, d, t, dev, data_group, model_group)


def single_device_mesh(device=None) -> Mesh:
    """The one-rank mesh: no process group, no collective."""
    return Mesh(1, 1, 1, 0, 0, torch.device(device) if device is not None else torch.device("cuda"))
