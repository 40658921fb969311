"""Tensor parallelism over the mesh's model axis: which leaves are sharded,
and each rank's local tree.

The port of ``gliclass.c_tpu.parallel.sharding``, with the same path rules
(the converter's naming is the contract): the kernels of

  * q, k, v, qkv, pos_q, pos_k, up, gate, linear_1, mlp_1 are column-parallel
    (``w``/``w_q`` on their last dim, their ``b`` and ``scale`` too);
  * o, down, linear_2, mlp_2 are row-parallel (``w``/``w_q`` on their
    second-last dim; ``b`` and ``scale`` replicated);

every other leaf is replicated. JAX hands the specs to XLA, which may cut a
dim at any column; the port runs its kernels on each rank's own heads and
intermediate width, so :func:`shard_params` cuts where that works:

  * **Head-aligned.** The attention pair (q/k/v/pos_q/pos_k and o) is
    sharded only when the query heads divide by tp, and, for GQA, when the
    kv heads divide by tp or tp by the kv heads. In the second case (e.g.
    qwen-1.5B's 2 kv heads at tp = 4) k and v are cut per rank to the one kv
    head its query heads read, and the ranks that share a kv head hold the
    same slice. Otherwise the whole pair stays replicated.
  * **Fused qkv per head.** A fused ``[H, 3H]`` qkv is cut into
    ``[q_local | k_local | v_local]``, not by columns. (The engine fuses q, k
    and v after sharding, which gives the same.)
  * **Row-parallel biases are replicated** and added once, after the
    reduction (``ops.layers.row_linear``).
  * **Per pair.** The divisibility rule is decided once for each layer pair
    (the leaves under one parent: attn, ffn, mlp, text_projector,
    classes_projector, scorer), so its column and row layers are both
    sharded or both replicated. :class:`ShardPlan` names the sharded pairs;
    the models read it through ``parallel.collectives.tp_group``.

JAX's ``shard_spec_tree`` (NamedShardings for jit's ``in_shardings`` and
Orbax's restore) has no counterpart: nothing here is jitted, and the port's
checkpoints gather the whole tree (``training.checkpoint``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from .mesh import Mesh

Params = dict[str, Any]

_COL_PARALLEL = {"q", "k", "v", "qkv", "pos_q", "pos_k", "up", "gate", "linear_1", "mlp_1"}
_ROW_PARALLEL = {"o", "down", "linear_2", "mlp_2"}
_KV = {"k", "v"}


def _leaf_dim(path: tuple[str, ...], ndim: int) -> int | None:
    """The dim of a leaf that the path rules shard over the model axis."""
    name = path[-1]
    parent = path[-2] if len(path) >= 2 else ""
    if name in ("w", "w_q"):
        if parent in _COL_PARALLEL:
            return ndim - 1
        if parent in _ROW_PARALLEL:
            return ndim - 2
        return None
    if name in ("b", "scale") and parent in _COL_PARALLEL:
        return ndim - 1
    return None


def _tree_paths(tree: Any, prefix: tuple[str, ...] = ()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tree_paths(v, prefix + (k,))
    else:
        yield prefix, tree


def _set(tree: Params, path: tuple[str, ...], value) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


def param_pspecs(params: Params) -> Params:
    """A tree mirroring ``params`` with, per leaf, the dim the path rules
    shard over the model axis, or None (JAX's PartitionSpec tree, with the
    position of its "model" axis in each spec)."""
    out: Params = {}
    for path, leaf in _tree_paths(params):
        _set(out, path, _leaf_dim(path, len(leaf.shape)))
    return out


@dataclass(frozen=True)
class ShardPlan:
    """What :func:`shard_params` sharded at this tp: the layer pairs (by
    their parent's name) and, for GQA, how many ranks share one kv head (1:
    the kv heads are sharded like the query heads)."""

    tp: int
    pairs: frozenset = frozenset()
    kv_share: int = 1


def _pair_width(node: Params) -> int | None:
    """The sharded width of a pair: its column layers' output width, when
    they all agree and its row layers read it."""
    widths = {v[k].shape[-1] for n, v in node.items() if n in _COL_PARALLEL for k in ("w", "w_q") if k in v}
    rows = {v[k].shape[-2] for n, v in node.items() if n in _ROW_PARALLEL for k in ("w", "w_q") if k in v}
    if len(widths) != 1 or (rows and rows != widths):
        return None
    return widths.pop()


def shard_plan(params: Params, tp: int, cfg=None) -> ShardPlan:
    """The pairs of ``params`` that shard at ``tp``. ``cfg`` (a
    GLiClassConfig or its BackboneConfig) gives the attention's head counts;
    without it the attention stays replicated."""
    if tp == 1:
        return ShardPlan(1)
    bb = getattr(cfg, "backbone", cfg)
    pairs, kv_share = set(), 1
    for path, node in _pair_nodes(params):
        name = path[-1]
        if name == "attn":
            if bb is None:
                continue
            nh = bb.num_attention_heads
            nkv = bb.kv_heads if bb.model_type in ("llama", "qwen2") else nh
            if nh % tp or not (nkv % tp == 0 or tp % nkv == 0):
                continue
            kv_share = 1 if nkv % tp == 0 else tp // nkv
            pairs.add(name)
        else:
            w = _pair_width(node)
            if w is not None and w % tp == 0:
                pairs.add(name)
    return ShardPlan(tp, frozenset(pairs), kv_share if "attn" in pairs else 1)


def _pair_nodes(params: Params, prefix: tuple[str, ...] = ()):
    """(path, node) of each dict that holds a column- or row-parallel layer."""
    if not isinstance(params, dict):
        return
    if any(k in _COL_PARALLEL | _ROW_PARALLEL and isinstance(v, dict) for k, v in params.items()):
        yield prefix, params
    for k, v in params.items():
        if isinstance(v, dict) and k not in _COL_PARALLEL | _ROW_PARALLEL:
            yield from _pair_nodes(v, prefix + (k,))


def chunk(t: torch.Tensor, dim: int, n: int, i: int) -> torch.Tensor:
    """Part ``i`` of ``n`` equal parts of ``t`` along ``dim`` (contiguous)."""
    size = t.shape[dim] // n
    return t.narrow(dim, i * size, size).contiguous()


def _local(leaf: torch.Tensor, path: tuple[str, ...], dim: int, plan: ShardPlan, rank: int) -> torch.Tensor:
    layer = path[-2]
    if layer == "qkv":  # [.. | q | k | v]: each third cut by head
        thirds = leaf.chunk(3, dim=dim)
        return torch.cat([chunk(t, dim, plan.tp, rank) for t in thirds], dim=dim)
    if layer in _KV and plan.kv_share > 1 and path[-3] == "attn":
        # Fewer kv heads than ranks: this rank's one kv head, shared by kv_share ranks.
        return chunk(leaf, dim, plan.tp // plan.kv_share, rank // plan.kv_share)
    return chunk(leaf, dim, plan.tp, rank)


def apply_plan(params: Params, plan: ShardPlan, model_rank: int) -> Params:
    """The local tree of ``plan`` at ``model_rank``: each sharded leaf cut,
    the replicated ones kept as they are."""
    if plan.tp == 1 or not plan.pairs:
        return params
    out: Params = {}
    for path, leaf in _tree_paths(params):
        dim = _leaf_dim(path, len(leaf.shape))
        pair = path[-3] if len(path) >= 3 else None
        if dim is not None and pair in plan.pairs:
            leaf = _local(leaf, path, dim, plan, model_rank)
        _set(out, path, leaf)
    return out


def shard_params(params: Params, mesh: Mesh, cfg=None) -> Params:
    """This rank's local tree of tensor leaves (replicated leaves are the
    same tensors), cut by :func:`shard_plan`. ``cfg`` as there: unlike
    JAX's, the port's cut needs the head counts."""
    return apply_plan(params, shard_plan(params, mesh.tp, cfg), mesh.model_rank)


def local_shard_dims(params: Params, plan: ShardPlan) -> Params:
    """Per leaf of a local tree: the dim on which it is one of tp shards, or
    None where it is replicated (the trainer's gradient norm and the
    checkpoint's gather read it)."""
    out: Params = {}
    for path, leaf in _tree_paths(params):
        dim = _leaf_dim(path, len(leaf.shape))
        pair = path[-3] if len(path) >= 3 else None
        _set(out, path, dim if dim is not None and pair in plan.pairs else None)
    return out
