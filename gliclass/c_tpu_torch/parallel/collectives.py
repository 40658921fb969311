"""The collectives of data and tensor parallelism, issued by the port itself.

JAX gets these from XLA's SPMD partitioner; the port has none, so the
models call them where a sharded layer ends. These functions are the only
places that call ``torch.distributed`` on the forward path. Each is a no-op
on a group of one (``None``).

Tensor parallelism is Megatron's: a column-parallel layer (output dim
sharded) reads a replicated input and gives a local slice; the row-parallel
layer after it (input dim sharded) gives a partial sum that
:func:`reduce_from_model` all-reduces. For training the pair is wrapped in
Megatron's f/g autograd functions: :func:`copy_to_model` is the identity
forward and an all-reduce backward (the input's gradient is partial on each
rank), :func:`reduce_from_model` the all-reduce forward and the identity
backward (its output, hence its gradient, is replicated).
``torch.distributed.nn.functional.all_reduce`` is not used for the latter:
its backward all-reduces the replicated gradient again, multiplying it by
the group's size.

The models find the model group through :func:`model_parallel` (a context
the engine and the trainer set around a forward) and :func:`tp_group`.

Gloo and CUDA tensors: gloo's all-reduce takes them (staging them through
host memory itself); its all-gather does not, so :func:`all_gather_rows`
gathers a CUDA tensor under gloo as an all-reduce sum of zero-padded
blocks, exact since x + 0 == x.
"""

from __future__ import annotations

import contextlib
import contextvars
import time
from dataclasses import dataclass

import torch
import torch.distributed as dist

# Collective calls since the last reset (a run's proof of what it issued), and,
# with ``timing`` set, the wall seconds spent in them (each synchronized before
# and after on the card, so that the time is the collective's own).
calls = 0
timing = False
seconds = 0.0


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


@contextlib.contextmanager
def _counted(t: torch.Tensor):
    global calls, seconds
    calls += 1
    if not timing:
        yield
        return
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    yield
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    seconds += time.perf_counter() - t0


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """In-place sum over ``group``; returns ``t``."""
    if group_size(group) > 1:
        with _counted(t):
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def all_reduce_max(t: torch.Tensor, group) -> torch.Tensor:
    """In-place maximum over ``group``; returns ``t``."""
    if group_size(group) > 1:
        with _counted(t):
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return t


def all_gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """The ranks' ``t`` (equal shapes) concatenated on dim 0 in group-rank
    order."""
    n = group_size(group)
    if n == 1:
        return t
    t = t.contiguous()
    with _counted(t):
        if t.is_cuda and dist.get_backend(group) == "gloo":
            out = torch.zeros((n * t.shape[0], *t.shape[1:]), dtype=t.dtype, device=t.device)
            r = dist.get_rank(group)
            out[r * t.shape[0]:(r + 1) * t.shape[0]] = t
            dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
            return out
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=group)
        return torch.cat(parts)


def all_gather_dim(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The ranks' ``t`` concatenated on ``dim`` (a sharded parameter made whole)."""
    if group_size(group) == 1:
        return t
    return all_gather_rows(t.movedim(dim, 0), group).movedim(0, dim).contiguous()


def _sum_f32(x: torch.Tensor, group) -> torch.Tensor:
    y = x.float().clone() if x.dtype == torch.float32 else x.float()
    return all_reduce_sum(y, group)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum_f32(g, ctx.group).to(g.dtype), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.dtype = x.dtype
        return _sum_f32(x, group)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's f: the input of a column-parallel layer. Identity forward;
    the backward all-reduces the gradient over ``group``."""
    if group_size(group) == 1 or not (torch.is_grad_enabled() and x.requires_grad):
        return x
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """Megatron's g: the sum over ``group`` of a row-parallel layer's partial
    outputs, in fp32 (reduced-precision partials are summed in fp32 and
    rounded once by the caller). Identity backward."""
    if group_size(group) == 1:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _ReduceFromModel.apply(x, group)
    return _sum_f32(x, group)


# ---------------------------------------------------------------------------
# The model group, as the models see it
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class _TP:
    group: object
    pairs: frozenset  # names of the sharded layer pairs (parallel.sharding.ShardPlan)


_TP_CTX = contextvars.ContextVar("gliclass_torch_tp", default=None)


@contextlib.contextmanager
def model_parallel(group, pairs):
    """Within this context the layer pairs named in ``pairs`` run sharded
    over ``group`` (the mesh's model group). Outside it, or with a group of
    one, every layer runs whole."""
    tok = _TP_CTX.set(_TP(group, frozenset(pairs)) if group_size(group) > 1 else None)
    try:
        yield
    finally:
        _TP_CTX.reset(tok)


def tp_group(pair: str):
    """The model group if layer pair ``pair`` ("attn", "ffn", "mlp",
    "text_projector", "classes_projector", "scorer") runs sharded here, else
    None."""
    tp = _TP_CTX.get()
    return tp.group if tp is not None and pair in tp.pairs else None
