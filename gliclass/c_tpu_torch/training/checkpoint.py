"""Training checkpoints with ``torch.save``: parameters, the optimizer's
``state_dict`` and the step, in one file.

The JAX package writes Orbax checkpoints (``gliclass.c_tpu.training.
checkpoint``); Orbax and this format do not read each other. Weights pass
between the packages as bundles (``convert/bundle.py``).

Like Orbax's, a checkpoint restores onto any mesh: a sharded state is saved
whole (each sharded parameter and its optimizer moments gathered over the
model group, written by global rank 0), and :func:`restore_train_state`
cuts it again for the state it restores into.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..parallel.collectives import all_gather_dim
from ..parallel.sharding import chunk, local_shard_dims
from .train import TrainState, param_leaves


def _flat(params, prefix: str = "") -> dict:
    if isinstance(params, dict):
        return {k: v for key in sorted(params) for k, v in _flat(params[key], f"{prefix}{key}/").items()}
    return {prefix[:-1]: params.detach() if isinstance(params, torch.Tensor) else params}


def _dims(state: TrainState) -> list:
    """Per parameter, in the optimizer's order: its sharded dim or None."""
    if state.plan is None or not state.plan.pairs:
        return [None] * len(param_leaves(state.params))
    return param_leaves(local_shard_dims(state.params, state.plan))


def _moments(osd: dict, params: list, fn) -> dict:
    """``osd`` with ``fn(i, tensor)`` applied to each optimizer state tensor
    shaped like parameter i (moments, momentum buffers); a new dict, the
    optimizer's own state untouched."""
    state = {i: {k: fn(i, v) if torch.is_tensor(v) and v.shape == params[i].shape else v for k, v in st.items()}
             for i, st in osd["state"].items()}
    return dict(osd, state=state)


def save_train_state(path: str, state: TrainState) -> None:
    """Write ``state`` whole. On a mesh every rank calls it (the gathers are
    collective); global rank 0 writes, and all return once it has."""
    flat = _flat(state.params)
    dims = _dims(state)
    group = state.mesh.model_group if state.mesh is not None else None
    full = {name: t if d is None else all_gather_dim(t, d, group) for (name, t), d in zip(flat.items(), dims)}
    local = list(flat.values())
    osd = _moments(state.optimizer.state_dict(), local,
                   lambda i, v: v if dims[i] is None else all_gather_dim(v, dims[i], group))
    distributed = dist.is_initialized() and state.mesh is not None and state.mesh.size > 1
    if not distributed or dist.get_rank() == 0:
        torch.save({"params": full, "optimizer": osd, "step": state.step}, path)
    if distributed:
        dist.barrier()


def restore_train_state(path: str, like: TrainState, mesh=None) -> TrainState:
    """Restore into the structure of ``like``, on its device: its params are
    overwritten in place (the tensors its optimizer holds), then the
    optimizer's state is loaded. A whole checkpoint is cut to ``like``'s
    shards (on ``mesh``, default ``like.mesh``). Raises if the trees
    differ."""
    dev = param_leaves(like.params)[0].device
    saved = torch.load(path, map_location=dev, weights_only=True)
    flat = _flat(like.params)
    if saved["params"].keys() != flat.keys():
        raise ValueError(f"{path}: parameter tree differs from the state it is restored into")
    mesh = mesh if mesh is not None else like.mesh
    dims = _dims(like)
    tp, rank = (mesh.tp, mesh.model_rank) if mesh is not None else (1, 0)
    cut = lambda t, d: t if d is None else chunk(t, d, tp, rank)
    full = [saved["params"][name] for name in flat]
    with torch.no_grad():
        for (name, t), d in zip(flat.items(), dims):
            t.copy_(cut(saved["params"][name], d))
    like.optimizer.load_state_dict(_moments(saved["optimizer"], full, lambda i, v: cut(v, dims[i])))
    like.step = saved["step"]
    return like
