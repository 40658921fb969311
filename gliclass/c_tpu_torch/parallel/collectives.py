"""The collectives of data, sequence and tensor parallelism, issued by the
port itself.

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
the engine and the trainer set around a forward) and :func:`tp_group`, and
the seq group through :func:`seq_parallel` and :func:`seq_shard`.

Sequence parallelism is the JAX package's: XLA's partitioner shards the
token axis of the activations over the seq axis and inserts the k/v
all-gathers attention needs. Here each seq rank runs its block of S/sp
tokens (:class:`SeqShard`) and :func:`all_gather_seq` gathers along the
token axis; its backward is a reduce-scatter, the sum of the ranks'
gradients of each block (as an all-reduce and a slice).

Lockstep serving: :func:`broadcast` sends the leader's host tensors over the
mesh's control group (``parallel.distributed.new_control_group``).

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


def broadcast(t: torch.Tensor, group) -> torch.Tensor:
    """In place: every rank's ``t`` becomes global rank 0's (the serving
    leader's); returns ``t``."""
    if group_size(group) > 1:
        with _counted(t):
            dist.broadcast(t, src=0, group=group)
    return t


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


class _GatherSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        n = g.shape[ctx.dim] // group_size(ctx.group)
        total = _sum_f32(g, ctx.group)
        return total.narrow(ctx.dim, dist.get_rank(ctx.group) * n, n).to(g.dtype).contiguous(), None, None


def all_gather_seq(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """The seq ranks' blocks of ``t`` concatenated on the token axis ``dim``,
    in seq-rank order. Backward: the reduce-scatter, the sum over the group
    of the gradient of this rank's block (in fp32)."""
    if group_size(group) == 1:
        return t
    dim = dim % t.dim()
    if torch.is_grad_enabled() and t.requires_grad:
        return _GatherSeq.apply(t, dim, group)
    return all_gather_dim(t, dim, group)


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


# ---------------------------------------------------------------------------
# The seq group, as the models see it
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class SeqShard:
    """This seq rank's block of a sequence: tokens ``off .. off + n - 1``."""

    group: object
    off: int
    n: int

    @property
    def rows(self) -> slice:
        return slice(self.off, self.off + self.n)


_SP_CTX = contextvars.ContextVar("gliclass_torch_sp", default=None)


@contextlib.contextmanager
def seq_parallel(group):
    """Within this context a sequence whose length the group's size divides
    runs token-sharded over ``group`` (the mesh's seq group)."""
    tok = _SP_CTX.set(group if group_size(group) > 1 else None)
    try:
        yield
    finally:
        _SP_CTX.reset(tok)


def seq_shard(S: int) -> SeqShard | None:
    """This rank's block of a length-S sequence, or None: outside
    :func:`seq_parallel`, and where the group's size does not divide S (the
    bucket then runs seq-replicated, as the JAX package's ``seq_sharding``
    falls back)."""
    group = _SP_CTX.get()
    sp = group_size(group)
    if sp == 1 or S % sp:
        return None
    n = S // sp
    return SeqShard(group, dist.get_rank(group) * n, n)
